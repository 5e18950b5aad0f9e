"""Prometheus text-exposition endpoint (``GET /metrics``).

A copy of ``repro/telemetry/prom.py`` (framework-free).

A stdlib ``ThreadingHTTPServer`` on a daemon thread: ``serve.py`` starts it
with ``--metrics-port`` (0 = ephemeral; the bound port is reported and kept
in ``LAST_SERVER`` so the in-process CI smoke can scrape without a race).
Scrapes call ``registry.render()`` on the serving thread's live objects —
pull bindings read plain python ints/floats, so a concurrent scrape is
torn-read-safe at worst, never corrupting."""
from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

log = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# most recent endpoint started in this process (CI smoke / tests)
LAST_SERVER: "MetricsServer | None" = None


class MetricsServer:
    def __init__(self, registry, port: int = 0, host: str = "127.0.0.1",
                 scrape_timeout: float = 10.0):
        reg = registry
        # default urlopen timeout for self-scrapes (tests / CI smoke);
        # per-call override via scrape(timeout=...)
        self.scrape_timeout = float(scrape_timeout)

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                       # noqa: N802 (stdlib API)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = reg.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):               # quiet access log
                pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()
        global LAST_SERVER
        LAST_SERVER = self

    @property
    def url(self) -> str:
        return f"http://{self.httpd.server_address[0]}:{self.port}/metrics"

    def scrape(self, timeout: float | None = None) -> str:
        """Fetch the endpoint over real HTTP (tests / CI smoke)."""
        from urllib.request import urlopen
        t = self.scrape_timeout if timeout is None else timeout
        with urlopen(self.url, timeout=t) as resp:
            assert resp.headers.get("Content-Type") == CONTENT_TYPE
            return resp.read().decode()

    def close(self, join_timeout: float = 5.0) -> bool:
        """Shut the endpoint down. Returns True once the serving thread has
        exited; if it is still alive after ``join_timeout`` the leak is
        REPORTED (warning log) and False is returned instead of being
        swallowed — the thread is a daemon, so the process can still exit,
        but a caller that cares (tests, long-lived servers restarting the
        endpoint) can now see the failure."""
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=join_timeout)
        if self._thread.is_alive():
            log.warning("metrics-http thread still alive %.1fs after "
                        "shutdown — leaked daemon thread", join_timeout)
            return False
        return True
