"""Emit-only OTLP/JSON span export.

Converts a finished `QueryTrace.to_dict()` document into one
OpenTelemetry `ResourceSpans` JSON object (the OTLP/HTTP JSON encoding)
and appends it as a single line to a local file
(`SessionConfig.otlp_export_path`).  Emit-only: no collector, no network
client, no dependency beyond the standard library; an operator who wants
the spans in a tracing backend hands the file to any OTLP-speaking agent.

Span identity: OTLP wants 16-byte trace ids and 8-byte span ids as hex.
The query_id hashes into the trace id; span ids are content hashes of
(name, path, start), so re-exports are deterministic.  Timestamps: the
tracer clock is monotonic-relative, so spans are anchored at the export
wall-clock minus the trace total: durations and tree structure are exact,
absolute placement is approximate to within the export delay.

Across processes: the trace id comes from the query_id alone, so a broker
and every historical serving the same query export under one trace id.  The
broker stamps each `cluster_rpc` span with an id computed before the span
closes (`rpc_span_id`, its `otlp_span_id` attr, sent in the
`X-Sdol-Parent-Span` header), and a historical's trace opened under that
header exports its root with it as `parentSpanId`.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Any, Dict, List, Optional


def _hex_id(seed: str, nbytes: int) -> str:
    return hashlib.sha256(seed.encode()).hexdigest()[: 2 * nbytes]


def rpc_span_id(query_id: str, node: str, attempt: int) -> str:
    """The OTLP span id of one broker attempt at a historical, known before
    the span closes (the broker sends it in the request's headers, and the
    export must emit the same id): a hash of (query id, node, attempt), so
    stable across exports and distinct across failovers and hedges."""
    return _hex_id(f"rpc:{query_id}:{node}:{int(attempt)}", 8)


def _attr(key: str, value: Any) -> Dict[str, Any]:
    """One OTLP KeyValue; numbers keep their type, everything else is
    stringified (OTLP AnyValue has no null/dict encoding we need)."""
    if isinstance(value, bool):
        v: Dict[str, Any] = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


def trace_to_otlp(
    doc: Dict[str, Any], epoch_ns: Optional[int] = None
) -> Dict[str, Any]:
    """One `QueryTrace.to_dict()` -> one OTLP/JSON ResourceSpans dict."""
    qid = str(doc.get("query_id", ""))
    trace_id = _hex_id("trace:" + qid, 16)
    total_ms = float(doc.get("total_ms", 0.0))
    if epoch_ns is None:
        epoch_ns = int((time.time() - total_ms / 1e3) * 1e9)
    spans: List[Dict[str, Any]] = []

    def walk(node: Dict[str, Any], parent_id: str, path: str) -> None:
        start_ms = float(node.get("start_ms", 0.0))
        dur_ms = float(node.get("duration_ms", 0.0))
        # an `otlp_span_id` attr pins the id (an attempt's, sent to the
        # historical before the span closed)
        pinned = (node.get("attrs") or {}).get("otlp_span_id")
        span_id = str(pinned) if pinned else _hex_id(
            f"span:{qid}:{path}:{node.get('name')}:{start_ms}", 8)
        start_ns = epoch_ns + int(start_ms * 1e6)
        span: Dict[str, Any] = {
            "traceId": trace_id,
            "spanId": span_id,
            "name": str(node.get("name", "span")),
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(start_ns + int(dur_ms * 1e6)),
        }
        if parent_id:
            span["parentSpanId"] = parent_id
        attrs = [
            _attr(k, v) for k, v in (node.get("attrs") or {}).items()
        ]
        if attrs:
            span["attributes"] = attrs
        events = [
            {
                "name": str(e.get("name", "event")),
                "timeUnixNano": str(
                    epoch_ns + int(float(e.get("at_ms", 0.0)) * 1e6)
                ),
                **(
                    {
                        "attributes": [
                            _attr(k, v)
                            for k, v in (e.get("attrs") or {}).items()
                        ]
                    }
                    if e.get("attrs")
                    else {}
                ),
            }
            for e in node.get("events", ())
        ]
        if events:
            span["events"] = events
        spans.append(span)
        for i, child in enumerate(node.get("children", ())):
            walk(child, span_id, f"{path}/{i}")

    root = doc.get("spans") or {}
    if root:
        # a historical's trace opened under a broker's attempt exports its
        # root as that attempt's child
        walk(root, str(doc.get("parent_span_id") or ""), "0")
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [
                        _attr("service.name", "spark-druid-olap-tpu-torch"),
                        _attr("sdol.query_id", qid),
                        _attr(
                            "sdol.query_type",
                            str(doc.get("query_type", "")),
                        ),
                    ]
                },
                "scopeSpans": [
                    {
                        "scope": {"name": "sdol.obs.trace"},
                        "spans": spans,
                    }
                ],
            }
        ]
    }


def append_otlp(path: str, doc: Dict[str, Any]) -> None:
    """Append one trace as one OTLP/JSON line.  O_APPEND line writes are
    atomic enough for the debug-artifact contract; concurrent queries
    each append whole lines."""
    line = json.dumps(trace_to_otlp(doc), separators=(",", ":"))
    with open(path, "a", encoding="utf-8") as f:
        f.write(line + "\n")
