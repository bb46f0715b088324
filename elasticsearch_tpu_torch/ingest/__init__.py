"""Ingest: the processors ES|QL's DISSECT and GROK pipes share
(`processors.py`). Pipelines are not ported yet."""
