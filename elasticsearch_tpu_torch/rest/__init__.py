"""The REST layer on the standard library: `app.RestApp` dispatches a
request to the engine, `server` serves it over HTTP/1.1."""

from .app import RestApp, make_app

__all__ = ["RestApp", "make_app"]
