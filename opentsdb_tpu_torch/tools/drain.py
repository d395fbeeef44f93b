"""``tsdb drain`` — absorb telnet ``put`` traffic during maintenance
(ref: ``tools/tsddrain.py``, ``opentsdb_tpu/tools/drain.py``: a low-end
TCP server that accepts collector traffic and dumps the datapoints to
one file per client IP, for batch import once storage is back).

Differences from the reference script, kept deliberately small:
- asyncio instead of a thread-per-connection SocketServer;
- the leading ``put `` verb is stripped so the spool files are directly
  consumable by ``tsdb import`` (TextImporter line format).

Usage: ``tsdb drain --port 4242 --dir /var/spool/tsd``.
"""

from __future__ import annotations

import asyncio
import os


class DrainServer:
    def __init__(self, drain_dir: str, host: str = "0.0.0.0",
                 port: int = 4242):
        self.drain_dir = drain_dir
        self.host = host
        self.port = port
        self.lines_received = 0
        self._server: asyncio.AbstractServer | None = None
        os.makedirs(drain_dir, exist_ok=True)

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, reuse_address=True)

    @property
    def bound_port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        client = peer[0] if peer else "unknown"
        path = os.path.join(self.drain_dir, client)
        try:
            with open(path, "a", encoding="utf-8") as out:
                while True:
                    line = await reader.readline()
                    if not line:
                        break
                    text = line.decode("utf-8", "replace").strip()
                    if not text:
                        continue
                    if text in ("exit", "quit", "diediedie"):
                        break
                    if text == "version":
                        # keep collectors that probe the TSD happy
                        writer.write(b"opentsdb_tpu_torch drain\n")
                        await writer.drain()
                        continue
                    if text.startswith("put "):
                        text = text[4:]
                    out.write(text + "\n")
                    # flush per line: concurrent connections from one
                    # client IP share the spool file, and buffered
                    # flushes at arbitrary boundaries would tear lines
                    out.flush()
                    self.lines_received += 1
        finally:
            writer.close()


def main(argv: list[str]) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="tsdb drain",
        description="Spool telnet put traffic to files during outages")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=4242)
    parser.add_argument("--dir", default="./tsd-drain",
                        help="spool directory (one file per client IP)")
    args = parser.parse_args(argv)
    server = DrainServer(args.dir, args.host, args.port)

    async def run():
        await server.start()
        print(f"draining port {args.port} -> {args.dir}", flush=True)
        await server.serve_forever()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    # the operator's import checklist: how much landed in the spool
    print(f"drained {server.lines_received} line(s) into {args.dir}",
          flush=True)
    return 0
