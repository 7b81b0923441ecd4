"""A historical: a read-only serving replica over the shared snapshot store.

One historical is a `TPUOlapContext` booted from the same `storage_dir` the
broker writes (the snapshot load reads the .npy headers only and maps the
columns; a segment's pages come in when a query first touches it, so a node
in effect loads only the segments it is asked for), and an `OlapServer`
over it, whose `POST /druid/v2/cluster/partial` computes a partial state
with the engine's `groupby_partials_host`: the hand-written group-by kernel
on the card.

A historical only reads the store: no fsync, no flush sweep, no compaction.
The broker owns the write path, so any number of processes share one
directory.  A restarted historical recovers as any context does (the
snapshot mapped, the WAL replayed past it) and answers 503 until the
replay is done; its replicas carry the traffic meanwhile.

It runs on the card: a node given no device and finding no card raises.
The CPU serves only when asked (`device="cpu"`, `--device cpu`).

In one process (the tests; `shutdown()` is a kill, a new node on the same
directory a restart):

    node = HistoricalNode("h0", storage_dir, device="cpu").start()
    ... node.url ...
    node.shutdown()

As its own process:

    python -m spark_druid_olap_tpu_torch.cluster.historical \\
        --storage-dir DIR --node-id h0 --port 0 --announce FILE [--device cpu]
        [--residency-mb N]

which writes {"node_id", "port", "url", "pid", "device"} to FILE once it
serves, and stops on SIGTERM or SIGINT.  `--residency-mb` caps the engine's
device residency, so several processes fit on one card together.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..utils.log import get_logger

log = get_logger("cluster.historical")


class HistoricalNode:
    """One historical in this process: a context and an HTTP server over a
    shared snapshot store."""

    def __init__(self, node_id: str, storage_dir: str, host: str = "127.0.0.1", port: int = 0,
                 config=None, device=None, residency_bytes: Optional[int] = None):
        self.node_id = node_id
        self.storage_dir = storage_dir
        self.host = host
        self._want_port = port
        self._config = config
        self._device = device
        self._residency_bytes = residency_bytes
        self.ctx = None
        self.server = None

    def start(self) -> "HistoricalNode":
        from ..api import TPUOlapContext
        from ..config import SessionConfig
        from ..exec.engine import resolve_device
        from ..server import OlapServer

        device = resolve_device(self._device)  # raises with no card and no device given
        cfg = self._config or SessionConfig.load_calibrated(device=device)
        # a reader of the shared store: no fsync (it never journals), no
        # flush sweep, no compaction
        cfg = dataclasses.replace(cfg, storage_dir=self.storage_dir, storage_fsync=False,
                                  snapshot_flush_s=0.0, compaction_interval_s=0.0)
        self.ctx = TPUOlapContext(cfg, device=device)
        if self._residency_bytes is not None:
            self.ctx.engine.set_residency_budget(self._residency_bytes)
        # the id the scatter route stamps on every partial it answers
        self.ctx.cluster_node_id = self.node_id
        self.server = OlapServer(self.ctx, host=self.host, port=self._want_port)
        self.server.start()
        log.info("historical %s serving %s on %s (%s)", self.node_id, self.storage_dir,
                 self.url, device)
        return self

    @property
    def port(self) -> int:
        return self.server.port if self.server else 0

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.server = None
        if self.ctx is not None:
            self.ctx.close()


def main(argv: Optional[list] = None) -> int:
    import argparse
    import os
    import signal
    import threading

    ap = argparse.ArgumentParser(
        prog="spark_druid_olap_tpu_torch.cluster.historical",
        description="serve one historical replica over a shared snapshot store")
    ap.add_argument("--storage-dir", required=True)
    ap.add_argument("--node-id", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the engine's device (default: the card; 'cpu' runs on the host)")
    ap.add_argument("--residency-mb", type=float, default=None,
                    help="cap on the engine's device residency, in MiB")
    ap.add_argument("--announce",
                    help="write {node_id, port, url, pid, device} as JSON here once serving")
    args = ap.parse_args(argv)
    budget = None if args.residency_mb is None else int(args.residency_mb * (1 << 20))
    node = HistoricalNode(args.node_id, args.storage_dir, host=args.host, port=args.port,
                          device=args.device, residency_bytes=budget).start()
    if args.announce:
        from ..catalog.persist import atomic_write_json

        atomic_write_json(args.announce, {
            "node_id": node.node_id, "port": node.port, "url": node.url, "pid": os.getpid(),
            "device": str(node.ctx.engine.device),
        })
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    node.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
