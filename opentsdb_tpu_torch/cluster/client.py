"""Blocking HTTP peer client for the cluster tier (ref:
``opentsdb_tpu/cluster/client.py``).

One short-lived ``http.client`` connection per request, carrying both
a connect and a read deadline — the router's failure semantics hang on
these timeouts (a hung peer must become a degraded partial, not a
stuck worker thread). Deliberately dependency-free and blocking: every
call runs on the router's dedicated fan-out pool, never on the server
event loop.
"""

from __future__ import annotations

import http.client
import socket


class PeerError(OSError):
    """Transport-level peer failure (connect/read/timeout/5xx): counts
    toward the peer's circuit breaker and degrades the request.
    Subclasses OSError so it rides the same retry ladders as disk
    faults (``utils.faults.call_with_retries`` defaults)."""


class PeerClient:
    """Address + deadlines of one peer TSD."""

    def __init__(self, host: str, port: int,
                 timeout_ms: float = 5000.0):
        self.host = host
        self.port = int(port)
        self.timeout_s = max(float(timeout_ms), 1.0) / 1000.0

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def request(self, method: str, path: str,
                body: bytes | None = None,
                timeout_s: float | None = None,
                headers: dict[str, str] | None = None
                ) -> tuple[int, bytes]:
        """One request; returns ``(status, body)``. 5xx and every
        transport failure raise :class:`PeerError`; 2xx-4xx return —
        a 400 from a healthy peer is not peer damage. ``headers``
        are extras (e.g. the ``X-TSD-Trace`` propagation header)."""
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=timeout_s if timeout_s is not None
            else self.timeout_s)
        try:
            all_headers = {"Content-Type": "application/json",
                           "Connection": "close"}
            if headers:
                all_headers.update(headers)
            conn.request(method, path, body=body,
                         headers=all_headers)
            resp = conn.getresponse()
            data = resp.read()
            status = resp.status
        except (OSError, http.client.HTTPException, socket.timeout) \
                as exc:
            raise PeerError(
                f"peer {self.address}: {type(exc).__name__}: {exc}"
            ) from exc
        finally:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                # teardown of an already-failed
                # or already-answered connection; nothing to report
                pass
        if status >= 500:
            raise PeerError(
                f"peer {self.address} answered {status}: "
                f"{data[:200]!r}")
        return status, data


def parse_peer_spec(spec: str) -> list[tuple[str, str, int]]:
    """Parse ``tsd.cluster.peers``: comma-separated
    ``[name=]host:port`` entries; the name defaults to ``host:port``.
    Returns ``[(name, host, port), ...]`` in config order."""
    out: list[tuple[str, str, int]] = []
    seen: set[str] = set()
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        name, _, addr = entry.rpartition("=")
        if not name:
            name = addr
        host, _, port_s = addr.rpartition(":")
        if not host or not port_s.isdigit():
            raise ValueError(
                f"bad tsd.cluster.peers entry {entry!r} "
                "(want [name=]host:port)")
        if name in seen:
            raise ValueError(
                f"duplicate cluster peer name {name!r}")
        seen.add(name)
        out.append((name, host, int(port_s)))
    return out


