"""The HTTP server of the replica, the stub replica and the fleet's router.

`socketserver` listens with a backlog of 5. A burst of more concurrent
connects than that, arriving while the accept loop is late (the host
busy with the engine), overflows the queue, and the overflowing clients'
connections are reset. A load generator's sessions, or a batch of
clients, connect at once; the backlog here holds such a burst.
"""

from __future__ import annotations

from http.server import ThreadingHTTPServer

LISTEN_BACKLOG = 128


class HTTPServer(ThreadingHTTPServer):
    """`ThreadingHTTPServer` with daemon handler threads and a listen
    backlog of `LISTEN_BACKLOG`."""

    daemon_threads = True
    request_queue_size = LISTEN_BACKLOG
