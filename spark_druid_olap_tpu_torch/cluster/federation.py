"""The broker's federated observability scrape.

Every historical keeps its registry and workload profile behind its own
port; the broker serves one merged view:

* `GET /status/metrics?cluster=1`: each historical's `/status/metrics`
  with a `node` label on every sample line (node ids pass the
  `bounded_label` cardinality guard), the family headers merged, and the
  broker's own registry under `node="broker"`;
* `GET /status/profile?cluster=1`: `{broker, nodes: {id: doc}, stale}`.

An unreachable historical never fails the scrape: it is absent from the
merged series and stamped 1 on the `sdol_cluster_scrape_stale` gauge, so a
dashboard tells "reports zero" from "unreachable".  Each node's fetch
passes the checkpoint `cluster.federate` first (a deadline bounds a scrape
over a large membership, and a test can arm the site); a fault there
propagates, it is not staleness.  With the broker's pool the fetches run
at once; node ids are sorted before they are submitted and folded in that
order, so the merged text is the same byte for byte either way.
"""

from __future__ import annotations

import json
import urllib.request
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

from ..obs import bounded_label
from ..resilience import checkpoint
from ..utils.log import get_logger

log = get_logger("cluster.federation")

__all__ = ["STALE_METRIC", "scrape_nodes", "scrape_nodes_json", "merge_prometheus"]

STALE_METRIC = "sdol_cluster_scrape_stale"

# one node's scraped body at most: a misbehaving node cannot swell the
# merged text past what a scrape client takes
_SCRAPE_MAX_BYTES = 4 << 20


def _fetch_node(url: str, path: str, timeout_s: float) -> Optional[str]:
    """One node's body, or None (stale) when the fetch fails.  The
    checkpoint runs outside the try: an armed fault or a deadline there
    propagates to the caller instead of passing for an unreachable node."""
    checkpoint("cluster.federate")
    try:
        with urllib.request.urlopen(url + path, timeout=timeout_s) as resp:
            return resp.read(_SCRAPE_MAX_BYTES).decode("utf-8", "replace")
    except Exception as e:  # an unreachable node is stale, never a 500
        log.warning("scrape of %s%s failed: %s", url, path, e)
        return None


def scrape_nodes(nodes: Dict[str, str], path: str, timeout_s: float,
                 pool=None) -> Dict[str, Optional[str]]:
    """GET `path` from every node, in node-id order; None marks an
    unreachable node.  With `pool` the fetches run at once (one slowest
    node's round trip), each still bounded by `timeout_s`."""
    items = sorted(nodes.items())
    if pool is None:
        return OrderedDict((nid, _fetch_node(url, path, timeout_s)) for nid, url in items)
    futs = [(nid, pool.submit(_fetch_node, url, path, timeout_s)) for nid, url in items]
    return OrderedDict((nid, fut.result()) for nid, fut in futs)


def scrape_nodes_json(nodes: Dict[str, str], path: str, timeout_s: float,
                      pool=None) -> Dict[str, Optional[dict]]:
    """`scrape_nodes` with each body parsed; a body that is not a JSON
    object is stale too."""
    docs: Dict[str, Optional[dict]] = {}
    for nid, text in scrape_nodes(nodes, path, timeout_s, pool).items():
        if text is None:
            docs[nid] = None
            continue
        try:
            doc = json.loads(text)
            docs[nid] = doc if isinstance(doc, dict) else None
        except ValueError:
            docs[nid] = None
    return docs


def _inject_node_label(line: str, node: str) -> str:
    """One sample line with node="..." first in its label set (or as the
    whole set)."""
    brace = line.find("{")
    space = line.find(" ")
    if brace != -1 and (space == -1 or brace < space):
        return f'{line[:brace + 1]}node="{node}",{line[brace + 1:]}'
    if space == -1:
        return line
    return f'{line[:space]}{{node="{node}"}}{line[space:]}'


def merge_prometheus(sections: Dict[str, Optional[str]]) -> str:
    """Every node's text exposition merged into one (format 0.0.4): family
    headers once (the first node's help text), every sample line
    node-labelled, other comments dropped (they cannot be attributed to a
    node), and the staleness gauge over the whole membership."""
    headers: "OrderedDict[str, List[str]]" = OrderedDict()
    samples: Dict[str, List[str]] = {}
    seen_headers: Set[Tuple[str, str]] = set()
    staleness: List[Tuple[str, int]] = []
    for node in sorted(sections):
        text = sections[node]
        nl = bounded_label("cluster_node", node or "unknown")
        staleness.append((nl, 0 if text is not None else 1))
        if text is None:
            continue
        fam = ""
        for line in text.splitlines():
            if line.startswith("# HELP") or line.startswith("# TYPE"):
                parts = line.split(None, 3)
                if len(parts) < 3:
                    continue
                kind, name = parts[1], parts[2]
                if kind == "TYPE":
                    fam = name
                if (name, kind) not in seen_headers:
                    seen_headers.add((name, kind))
                    headers.setdefault(name, []).append(line)
            elif not line or line.startswith("#"):
                continue
            else:
                key = fam or line.split("{", 1)[0].split(" ", 1)[0]
                headers.setdefault(key, [])
                samples.setdefault(key, []).append(_inject_node_label(line, nl))
    lines: List[str] = []
    for fam, hdr in headers.items():
        lines.extend(hdr)
        lines.extend(samples.get(fam, ()))
    lines.append(f"# HELP {STALE_METRIC} last federated scrape of this node "
                 "failed (1 = metrics below exclude it)")
    lines.append(f"# TYPE {STALE_METRIC} gauge")
    for nl, stale in staleness:
        lines.append(f'{STALE_METRIC}{{node="{nl}"}} {stale}')
    return "\n".join(lines) + "\n"
