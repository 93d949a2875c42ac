"""Minimal stdlib HTTP client for a :class:`~repro_torch.serve.server.BlazeServer`
(the port's copy of ``repro/serve/client.py``).

Uses only ``http.client`` so examples, tests, and benchmarks can hammer the
server from many threads without extra dependencies.  Typed server errors
come back as :class:`RemoteServeError` carrying the server's error ``code``
(``QUEUE_FULL``, ``QUERY_ERROR``, ...) and HTTP status, so callers can
branch on failure kind exactly like in-process callers branch on
``ServeError`` subclasses.
"""
from __future__ import annotations

import http.client
import json
import urllib.parse

from repro_torch.serve.codec import decode_payload

__all__ = ["BlazeClient", "RemoteServeError"]


class RemoteServeError(RuntimeError):
    """A typed error relayed from the server (``.code``, ``.status``)."""

    def __init__(self, code: str, status: int, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.status = status


class BlazeClient:
    """One tenant's connection-per-call view of a running server.

    >>> c = BlazeClient(server.url, tenant="alice")
    >>> result, meta = c.query("pi", {"n_samples": 1 << 16, "iters": 4})
    >>> c.stats()["completed"]
    """

    def __init__(self, url: str, tenant: str = "default",
                 timeout: float = 300.0):
        parsed = urllib.parse.urlparse(url)
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or 80
        self.tenant = tenant
        self.timeout = timeout

    def _request(self, method: str, path: str, body: dict | None = None):
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            payload = None if body is None else json.dumps(body).encode()
            headers = {"Content-Type": "application/json"} if payload else {}
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            data = json.loads(resp.read().decode() or "{}")
            return resp.status, data
        finally:
            conn.close()

    def query(self, query: str, params: dict | None = None,
              tenant: str | None = None):
        """Run one query; returns ``(result, meta)`` with arrays decoded
        bit-exactly, or raises :class:`RemoteServeError`."""
        status, data = self._request("POST", "/query", {
            "tenant": self.tenant if tenant is None else tenant,
            "query": query,
            "params": params or {},
        })
        if status != 200 or not data.get("ok"):
            raise RemoteServeError(
                data.get("error", "HTTP_ERROR"), status,
                data.get("message", f"HTTP {status}"),
            )
        return decode_payload(data["result"]), data.get("meta", {})

    def stats(self) -> dict:
        status, data = self._request("GET", "/stats")
        if status != 200:
            raise RemoteServeError("STATS_ERROR", status, str(data))
        return data

    def health(self) -> dict:
        status, data = self._request("GET", "/health")
        if status != 200:
            raise RemoteServeError("HEALTH_ERROR", status, str(data))
        return data
