"""ES|QL, SQL and EQL: the JAX package's `esql` package in PyTorch.

`esql_query` answers `POST /_query`; `sql.sql_query` `POST /_sql`;
`eql.eql_search` `/{index}/_eql/search`. The pipe stages run on the host
over numpy columns (`engine.py`); the sharded SORT | LIMIT (`topn.py`) and
STATS (`exchange.py`) run as torch programs on the index's device.
"""

from .engine import esql_query  # noqa: F401
