"""The cluster tier: a broker and N historicals over one shared snapshot
store.

A broker is a normal `TPUOlapContext` with a `ClusterClient` attached: it
owns the write path and answers locally whatever the scatter does not
cover.  A historical (`HistoricalNode`, or `python -m
spark_druid_olap_tpu_torch.cluster.historical` as its own process) boots
the same `storage_dir` read-only and serves partial states of its assigned
replicas, computed on the card by the hand-written group-by kernel.

  * `assignment`: rendezvous-hashed segment -> replica chain maps, epochs
    and the manifest;
  * `wire`: the partial-state codec (base64 arrays with dtype and shape,
    decoded strictly) and the trace headers;
  * `historical`: the serving replica;
  * `broker`: scatter with retries, hedges and breakers, and the gather in
    chain order with coverage accounting;
  * `federation`: the broker's merged metrics and profile scrape.

Every document on the wire is the JAX package's, so a broker of either
package serves over historicals of the other.
"""

from .assignment import (
    Assignment,
    build_assignment,
    load_assignment,
    rebalance,
    replicas_for,
    save_assignment,
)
from .broker import ClusterClient, ReplicaSetLost
from .historical import HistoricalNode
from .wire import WireDecodeError, decode_state, encode_state

__all__ = [
    "Assignment",
    "ClusterClient",
    "HistoricalNode",
    "ReplicaSetLost",
    "WireDecodeError",
    "build_assignment",
    "decode_state",
    "encode_state",
    "load_assignment",
    "rebalance",
    "replicas_for",
    "save_assignment",
]
