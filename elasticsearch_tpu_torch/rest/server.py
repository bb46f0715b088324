"""The HTTP server of the port, on the standard library:

    python -m elasticsearch_tpu_torch.rest.server [--host 127.0.0.1] [--port 9200]
        [--device cuda|cpu]

HTTP/1.1 with keep-alive, one thread per connection
(`http.server.ThreadingHTTPServer`), every request dispatched through
`rest.app.RestApp.handle`. Without a CUDA card it refuses to start unless
`--device cpu` is given. `serve(app, host, port)` starts a server in the
background of the calling process and returns it.
"""

from __future__ import annotations

import argparse
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlsplit

from .app import RestApp, make_app


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: one connection, many requests
    # the headers and the body leave in two writes: without TCP_NODELAY the
    # body waits for the client's delayed ACK of the headers (~40 ms)
    disable_nagle_algorithm = True

    def _dispatch(self):
        url = urlsplit(self.path)
        query = {}
        for k, v in parse_qsl(url.query, keep_blank_values=True):
            query.setdefault(k, v)  # the first value wins, as aiohttp's query.get
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        status, headers, payload = self.server.app.handle(
            self.command, url.path, query, dict(self.headers.items()), body)
        self.send_response(status)
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        if payload:
            self.wfile.write(payload)

    do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _dispatch

    def log_message(self, format, *args):  # noqa: A002 - the base class's name
        pass  # no line per request on stderr


class RestServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, app: RestApp, host: str, port: int):
        super().__init__((host, port), _Handler)
        self.app = app

    @property
    def port(self) -> int:
        return self.server_address[1]

    def stop(self) -> None:
        """Stop serving, close the socket and the app."""
        self.shutdown()
        self.server_close()
        self.app.close()


def serve(app: RestApp, host: str = "127.0.0.1", port: int = 0) -> RestServer:
    """Serve `app` on (host, port) from a background thread (port 0: any
    free port, see `.port`). `.stop()` ends it."""
    server = RestServer(app, host, port)
    threading.Thread(target=server.serve_forever, name="rest-server", daemon=True).start()
    return server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="elasticsearch_tpu_torch REST server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9200)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; without a card only cpu starts")
    args = ap.parse_args(argv)
    try:
        app = make_app(device=args.device)
    except RuntimeError as ex:
        print(f"elasticsearch_tpu_torch.rest.server: {ex}", file=sys.stderr)
        return 2
    server = RestServer(app, args.host, args.port)
    print(f"listening on http://{args.host}:{server.port} ({app.engine.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        app.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
