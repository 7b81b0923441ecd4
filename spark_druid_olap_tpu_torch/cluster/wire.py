"""The cluster's wire codec: host partial states and trace headers over HTTP.

A broker and its historicals exchange the engine's host partial state
(`exec.engine.Engine.groupby_partials_host`):

    {"sums": f64[G, A], "mins": f64[G, M], "maxs": f64[G, M],
     "sketches": {name: array}}

as JSON, each array a dtype, a shape and a base64 payload; the document is
the JAX package's, byte for byte, so a broker of either package reads a
historical of the other.  Decoding is strict: a torn body (the
`cluster.torn_response` fault site truncates one), a missing key or a
payload whose size disagrees with its dtype and shape raises
`WireDecodeError`, which the broker takes as a failed replica; a corrupt
answer never reaches the merge.

The trace rides the same responses with the opposite posture: a
historical's rendered span subtree (`encode_trace`, `decode_trace`) that is
torn, oversized or malformed degrades to an `untraced` stub and never fails
the replica.  `trace_headers` are the headers the broker sends with every
attempt (`X-Druid-Query-Id`, and `X-Sdol-Parent-Span`, the OTLP id of its
`cluster_rpc` span), so both processes trace under one identity.
"""

from __future__ import annotations

import base64
import json
from typing import Dict, Optional

import numpy as np

__all__ = [
    "WireDecodeError",
    "encode_state",
    "decode_state",
    "HEADER_QUERY_ID",
    "HEADER_PARENT_SPAN",
    "TRACE_MAX_BYTES",
    "trace_headers",
    "encode_trace",
    "decode_trace",
    "untraced_stub",
]

_STATE_KEYS = ("sums", "mins", "maxs")

HEADER_QUERY_ID = "X-Druid-Query-Id"
HEADER_PARENT_SPAN = "X-Sdol-Parent-Span"

# the most one rendered span subtree may take on the wire, each way: past
# it the subtree degrades to an `untraced` stub and the state ships as it is
TRACE_MAX_BYTES = 262_144


class WireDecodeError(ValueError):
    """A replica's response that does not decode into a whole partial state
    (torn payload, missing key, size and shape at odds)."""


def _encode_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def _decode_array(doc) -> np.ndarray:
    if not isinstance(doc, dict):
        raise WireDecodeError(f"array doc is {type(doc).__name__}, not dict")
    try:
        dtype = np.dtype(doc["dtype"])
        shape = tuple(int(x) for x in doc["shape"])
        raw = base64.b64decode(str(doc["data"]).encode("ascii"), validate=True)
    except Exception as e:
        raise WireDecodeError(f"malformed array doc: {e}") from e
    want = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
    if len(raw) != want:
        raise WireDecodeError(
            f"torn array payload: {len(raw)} bytes for {dtype}{list(shape)} (want {want})")
    # a copy: a frombuffer view is read-only, and the merge folds in place
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def encode_state(state: dict) -> dict:
    """A host partial state as a JSON-safe document."""
    doc = {k: _encode_array(state[k]) for k in _STATE_KEYS}
    doc["sketches"] = {
        str(name): _encode_array(arr)
        for name, arr in (state.get("sketches") or {}).items()
    }
    return doc


def decode_state(doc) -> Dict[str, object]:
    """A document back into a host partial state; raises `WireDecodeError`
    on anything short of a whole valid state."""
    if not isinstance(doc, dict):
        raise WireDecodeError(f"state doc is {type(doc).__name__}, not dict")
    missing = [k for k in _STATE_KEYS if k not in doc]
    if missing:
        raise WireDecodeError(f"state doc missing keys {missing}")
    state = {k: _decode_array(doc[k]) for k in _STATE_KEYS}
    sk = doc.get("sketches")
    if sk is not None and not isinstance(sk, dict):
        raise WireDecodeError("sketches member is not a dict")
    state["sketches"] = {str(name): _decode_array(arr) for name, arr in (sk or {}).items()}
    return state


# -- the trace (lenient: it degrades, it never fails a replica) --------------


def trace_headers(query_id: str, parent_span_id: str = "") -> Dict[str, str]:
    """The headers of one attempt: the query id both processes trace under,
    and the broker's span id the historical records as its parent."""
    headers = {HEADER_QUERY_ID: str(query_id or "")}
    if parent_span_id:
        headers[HEADER_PARENT_SPAN] = str(parent_span_id)
    return headers


def untraced_stub(node: str, reason: str) -> dict:
    """What stands where a historical's subtree would: a zero-length node of
    a rendered span's shape, whose attrs name the node and the reason."""
    return {
        "name": "query",
        "start_ms": 0.0,
        "duration_ms": 0.0,
        "attrs": {
            "node": str(node or "?"),
            "remote": True,
            "untraced": True,
            "reason": str(reason or "unknown"),
        },
    }


def _valid_span_node(node, depth: int = 0) -> bool:
    """A rendered span node's shape: a dict with a string name, numeric
    times, dict attrs and valid children, to a bounded depth."""
    if depth > 64 or not isinstance(node, dict):
        return False
    if not isinstance(node.get("name"), str):
        return False
    for key in ("start_ms", "duration_ms"):
        if not isinstance(node.get(key, 0.0), (int, float)):
            return False
    attrs = node.get("attrs")
    if attrs is not None and not isinstance(attrs, dict):
        return False
    children = node.get("children")
    if children is None:
        return True
    if not isinstance(children, list):
        return False
    return all(_valid_span_node(c, depth + 1) for c in children)


def encode_trace(trace_doc: Optional[dict], max_bytes: int = TRACE_MAX_BYTES) -> Optional[dict]:
    """The historical's side: `QueryTrace.to_dict()`'s subtree ready to ride
    the response (its receipt inside the root), or an `untraced` stub when
    it is malformed or oversized.  Never raises."""
    if not isinstance(trace_doc, dict):
        return None
    node = trace_doc.get("spans")
    if not _valid_span_node(node):
        return untraced_stub("", "malformed local trace")
    subtree = dict(node)
    receipt = trace_doc.get("receipt")
    if isinstance(receipt, dict):
        subtree["receipt"] = receipt
    try:
        if len(json.dumps(subtree)) > max(1024, int(max_bytes)):
            return untraced_stub("", "trace payload over size cap")
    except (TypeError, ValueError):
        return untraced_stub("", "unserializable trace payload")
    return subtree


def decode_trace(doc, node: str, max_bytes: int = TRACE_MAX_BYTES) -> dict:
    """The broker's side: a replica's trace payload as a graftable subtree,
    or an `untraced` stub for `node` on any defect.  Never raises."""
    if doc is None:
        return untraced_stub(node, "replica returned no trace")
    try:
        if not _valid_span_node(doc):
            return untraced_stub(node, "malformed trace payload")
        if len(json.dumps(doc)) > max(1024, int(max_bytes)):
            return untraced_stub(node, "trace payload over size cap")
    except Exception:  # a payload that does not even serialize
        return untraced_stub(node, "undecodable trace payload")
    out = dict(doc)
    attrs = dict(out.get("attrs") or {})
    attrs.setdefault("node", str(node or "?"))
    attrs["remote"] = True
    out["attrs"] = attrs
    return out
