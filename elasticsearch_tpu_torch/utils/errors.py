"""Error classes of the ES REST error surface used by the ported modules.

Each carries an HTTP `status` and an ES-style `type` string, so a response
layer can emit the standard envelope
  {"error": {"type": ..., "reason": ...}, "status": N}
(reference behavior: server/.../ElasticsearchException.java).
"""


class ElasticsearchTpuError(Exception):
    status = 500
    type = "exception"

    def __init__(self, reason: str = "", **meta):
        super().__init__(reason)
        self.reason = reason
        self.meta = meta

    def to_dict(self):
        err = {"type": self.type, "reason": self.reason}
        err.update(self.meta)
        return {"error": err, "status": self.status}


class MapperParsingError(ElasticsearchTpuError):
    status = 400
    type = "mapper_parsing_exception"


class QueryParsingError(ElasticsearchTpuError):
    status = 400
    type = "parsing_exception"


class IllegalArgumentError(ElasticsearchTpuError):
    status = 400
    type = "illegal_argument_exception"


class IndexNotFoundError(ElasticsearchTpuError):
    status = 404
    type = "index_not_found_exception"

    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]", index=index)


class IndexAlreadyExistsError(ElasticsearchTpuError):
    status = 400
    type = "resource_already_exists_exception"

    def __init__(self, index: str):
        super().__init__(f"index [{index}] already exists", index=index)


class ResourceAlreadyExistsError(ElasticsearchTpuError):
    status = 400
    type = "resource_already_exists_exception"


class ResourceNotFoundError(ElasticsearchTpuError):
    status = 404
    type = "resource_not_found_exception"


class VersionConflictError(ElasticsearchTpuError):
    status = 409
    type = "version_conflict_engine_exception"


class DocumentMissingError(ElasticsearchTpuError):
    status = 404
    type = "document_missing_exception"


class ActionRequestValidationError(ElasticsearchTpuError):
    """Pre-execution request validation (the reference's
    ActionRequestValidationException: reason lists numbered failures)."""

    status = 400
    type = "action_request_validation_exception"

    def __init__(self, *failures: str):
        joined = "; ".join(f"{i + 1}: {f}" for i, f in enumerate(failures))
        super().__init__(f"Validation Failed: {joined};")


class SearchPhaseExecutionError(ElasticsearchTpuError):
    """Every target of a search over several indices failed: the
    reference's SearchPhaseExecutionException, rendered 503 with the
    per-index failure list in the envelope."""

    status = 503
    type = "search_phase_execution_exception"

    def __init__(self, reason: str = "", failures: list | None = None):
        super().__init__(reason, **({"failed_shards": failures} if failures else {}))


def not_yet_ported(what: str) -> IllegalArgumentError:
    """The 400 a request surface of the reference answers with when the port
    does not carry it yet."""
    return IllegalArgumentError(f"{what} is not yet ported")
