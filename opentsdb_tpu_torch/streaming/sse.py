"""Server-Sent Events transport for continuous-query push results
(ref: ``opentsdb_tpu/streaming/sse.py``).

One subscription = one bounded :class:`queue.Queue` of pre-formatted
SSE frames. The registry publishes each update frame once and offers
it to every subscriber with ``put_nowait`` — a consumer that cannot
keep up (queue full) is SHED: marked dropped, removed from the
subscriber set, and its stream ends with a terminal ``shed`` event.
Backpressure therefore never propagates into the ingest path and a
stalled dashboard can never make the registry buffer unboundedly.

The generator produced by :func:`sse_stream` is consumed by the HTTP
server's chunked-streaming writer; between events it wakes every
``tsd.streaming.heartbeat_s`` to pump pending folds (so a quiet
subscriber still sees updates without a dedicated publisher thread)
and emits comment keepalives.
"""

from __future__ import annotations

import json
import logging
import queue
import time

LOG = logging.getLogger("streaming.sse")


class Subscription:
    """One SSE consumer: a bounded frame queue + shed flag."""

    __slots__ = ("queue", "dropped", "created", "events")

    def __init__(self, maxsize: int):
        self.queue: queue.Queue = queue.Queue(maxsize=max(maxsize, 1))
        self.dropped = False
        self.created = time.time()
        self.events = 0


def frame(event: str, payload: dict,
          event_id: int | None = None) -> bytes:
    """One SSE frame: optional ``id:`` (the per-query emit sequence —
    browsers echo the last one back as ``Last-Event-ID`` on
    reconnect), ``event: <type>`` + one JSON ``data:`` line."""
    body = json.dumps(payload, allow_nan=False, separators=(",", ":"))
    head = f"id: {event_id}\n" if event_id is not None else ""
    return (f"{head}event: {event}\ndata: {body}\n\n").encode()


def offer_frame(sub: Subscription, fr: bytes) -> bool:
    """Non-blocking delivery; a full queue sheds the subscriber."""
    if sub.dropped:
        return False
    try:
        sub.queue.put_nowait(fr)
    except queue.Full:
        sub.dropped = True
        return False
    sub.events += 1
    return True


def sse_stream(registry, cq, max_lifetime_s: float = 0.0,
               last_event_id: int | None = None):
    """Generator of SSE byte chunks for one subscriber (consumed by
    the server's chunked writer on a worker thread).

    ``last_event_id`` (the browser's ``Last-Event-ID`` reconnect
    header) resumes the stream: the registry replays only the
    ``windows`` events published since that id instead of the full
    snapshot, falling back to a snapshot when the id has aged out of
    the bounded replay history."""
    sub = registry.subscribe(cq, last_event_id=last_event_id)
    heartbeat = max(registry.heartbeat_s, 0.05)
    started = time.monotonic()
    try:
        yield b"retry: 5000\n\n"
        while True:
            if cq.closed:
                yield frame("end", {"id": cq.id, "reason": "deleted"})
                return
            if sub.dropped:
                # shed: the queue overflowed while we slept — tell the
                # client it missed updates and end the stream cleanly
                yield frame("shed", {
                    "id": cq.id,
                    "reason": "slow consumer: event queue overflow"})
                return
            if max_lifetime_s and \
                    time.monotonic() - started > max_lifetime_s:
                yield frame("end", {"id": cq.id, "reason": "lifetime"})
                return
            try:
                yield sub.queue.get(timeout=heartbeat)
                continue
            except queue.Empty:
                pass
            # quiet period: fold pending ingest and publish if dirty,
            # else keep the connection alive with a comment
            try:
                registry.pump(cq)
            except Exception:  # noqa: BLE001 - never kill the stream
                # a pump hiccup must not end a long-lived dashboard
                # stream; the next heartbeat pumps again
                LOG.exception("SSE pump failed for %s", cq.id)
            try:
                yield sub.queue.get_nowait()
            except queue.Empty:
                yield b": keepalive\n\n"
    finally:
        registry.unsubscribe(cq, sub)
