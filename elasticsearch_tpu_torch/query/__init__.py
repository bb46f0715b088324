from .dsl import parse_query
from .executor import ShardResult, ShardSearcher, pack_to_device

__all__ = ["ShardResult", "ShardSearcher", "pack_to_device", "parse_query"]
