"""Segment -> historical assignment: rendezvous hashing and epochs.

Druid's coordinator assigns segments to historicals with a replication
factor and moves them when the membership changes.  Here each segment's
replica chain is its top R nodes by rendezvous (highest random weight)
hashing of its `segment_id`, a string every process booting the same
snapshot agrees on (segment uids differ between processes).  The arithmetic
is the JAX package's, so both give the same chains and manifests:

* **Deterministic.**  Every broker computing the map of the same segments,
  nodes and replication gets the same map, without coordination.
* **Minimal movement.**  A node that leaves moves only the segments it held
  (each promotes its next-ranked replica); a node that joins takes only the
  segments that now rank it in their top R, so a rolling restart never
  reshuffles the cluster.
* **Epochs.**  Every rebalance bumps a monotonic epoch, saved in the
  assignment manifest beside the snapshots (`catalog/persist.py`).

The map also pins each datasource's snapshot version: the broker never
merges a replica's state computed at another version.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

from ..catalog.persist import load_assignment_manifest, save_assignment_manifest

__all__ = [
    "Assignment",
    "build_assignment",
    "rebalance",
    "replicas_for",
    "save_assignment",
    "load_assignment",
]


def _score(segment_id: str, node_id: str) -> int:
    h = hashlib.sha256(f"{segment_id}|{node_id}".encode("utf-8")).digest()
    return int.from_bytes(h[:8], "big")


def replicas_for(segment_id: str, nodes: Iterable[str], replication: int) -> Tuple[str, ...]:
    """A segment's top R nodes by rendezvous weight, primary first, clamped
    to the membership."""
    ranked = sorted(nodes, key=lambda n: (_score(segment_id, n), n), reverse=True)
    return tuple(ranked[: max(1, int(replication))])


@dataclasses.dataclass(frozen=True)
class Assignment:
    """One epoch's segment -> replica chain map."""

    epoch: int
    replication: int
    nodes: Tuple[str, ...]  # the sorted membership at this epoch
    # segment_id -> replica chain (primary first)
    segment_map: Dict[str, Tuple[str, ...]]
    # datasource -> the snapshot version the map was computed at
    versions: Dict[str, int]

    def replicas(self, segment_id: str) -> Tuple[str, ...]:
        return self.segment_map.get(segment_id, ())

    def segments_for(self, node_id: str) -> List[str]:
        return sorted(sid for sid, chain in self.segment_map.items() if node_id in chain)

    def deficit(self, live_nodes: Iterable[str]) -> Tuple[int, int]:
        """(segments below their replication, segments with no live replica)
        against the live membership: the health gauges."""
        live = set(live_nodes)
        under = lost = 0
        for chain in self.segment_map.values():
            alive = sum(1 for n in chain if n in live)
            if alive < len(chain):
                under += 1
            if alive == 0:
                lost += 1
        return under, lost

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "replication": self.replication,
            "nodes": list(self.nodes),
            "segment_map": {sid: list(chain) for sid, chain in sorted(self.segment_map.items())},
            "versions": dict(self.versions),
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "Assignment":
        return cls(
            epoch=int(doc["epoch"]),
            replication=int(doc["replication"]),
            nodes=tuple(doc["nodes"]),
            segment_map={str(sid): tuple(chain) for sid, chain in doc["segment_map"].items()},
            versions={str(k): int(v) for k, v in doc.get("versions", {}).items()},
        )


def build_assignment(segment_ids: Dict[str, List[str]], nodes: Iterable[str], replication: int,
                     epoch: int = 1, versions: Optional[Dict[str, int]] = None) -> Assignment:
    """The map at `epoch` of {datasource: [segment_id, ...]} over `nodes`."""
    members = tuple(sorted(set(nodes)))
    seg_map: Dict[str, Tuple[str, ...]] = {}
    for _ds, sids in sorted(segment_ids.items()):
        for sid in sids:
            seg_map[sid] = replicas_for(sid, members, replication) if members else ()
    return Assignment(epoch=int(epoch), replication=int(replication), nodes=members,
                      segment_map=seg_map, versions=dict(versions or {}))


def rebalance(prev: Assignment, nodes: Iterable[str],
              segment_ids: Optional[Dict[str, List[str]]] = None,
              versions: Optional[Dict[str, int]] = None) -> Assignment:
    """The next epoch's map after a change of membership or segments."""
    if segment_ids is None:
        segment_ids = {"": sorted(prev.segment_map)}
    return build_assignment(segment_ids, nodes, prev.replication, epoch=prev.epoch + 1,
                            versions=versions if versions is not None else prev.versions)


def save_assignment(directory: str, asg: Assignment) -> str:
    return save_assignment_manifest(directory, asg.to_dict())


def load_assignment(directory: str) -> Optional[Assignment]:
    doc = load_assignment_manifest(directory)
    return Assignment.from_dict(doc) if doc else None
