"""The cluster's chaos matrix in the PyTorch port, the cells of the JAX
package's `tests/test_cluster_chaos.py`.

Every cell runs one shape: a port broker and in-process port historicals
(on the CPU) over one shared snapshot store, a fault armed at a cluster
site (`resilience.CLUSTER_SITES`) or a node shut down, queries through the
loss, and an assertion on the answer: exact through a replica, a
coverage-stamped partial when a whole replica set is gone, never a 500.

* kill a historical mid-query, a torn response, failed and slow RPCs:
  failover, the exact answer;
* every replica of a segment lost, every node down: a stamped partial;
* a rolling restart of every historical: no failed query;
* a node replaying its WAL answers 503 with Retry-After while its replicas
  carry the traffic, then rejoins with the same bytes; a restarted node
  serves the rows the broker flushed meanwhile;
* traces under chaos: one tree, error spans for failed attempts, grafts
  under good ones, hedges marked, an absent trace degraded to a stub, and
  the receipt's per-node buckets;
* the federated scrape with a dead node (stale, never a 500) and the
  pooled scrape equal to the serial one.

The fault injector is process-wide and the historicals run in this
process: `cluster.historical_kill` fires only in a historical's scatter
route, `cluster.rpc` and `cluster.torn_response` only in the broker's
attempt, so each site hits one side.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.cluster import ClusterClient, HistoricalNode
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.resilience import injector

T0 = int(np.datetime64("2023-01-01", "ms").astype(np.int64))
DAY = 86_400_000

Q = (
    "SELECT city, sum(qty) AS q, count(*) AS n "
    "FROM ev GROUP BY city ORDER BY city"
)


@pytest.fixture(autouse=True)
def _disarm():
    injector().disarm()
    yield
    injector().disarm()


def _cols(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    return {
        "city": rng.choice(
            np.array(["austin", "boston", "chicago"], dtype=object), n
        ),
        "qty": rng.integers(1, 100, n).astype(np.int64),
        "ts": T0 + rng.integers(0, 30, n) * DAY,
    }


class _Cluster:
    def __init__(self, d, n_nodes=2, replication=2, n=3000, **cfg_kw):
        cfg_kw.setdefault("cluster_breaker_cooldown_ms", 50.0)
        self.d = str(d)
        self.broker = TPUOlapContext(
            SessionConfig(storage_dir=self.d, **cfg_kw), device="cpu"
        )
        self.broker.register_table(
            "ev", _cols(n), dimensions=["city"], metrics=["qty"],
            time_column="ts", rows_per_segment=800,
        )
        self.nodes = {}
        for i in range(n_nodes):
            h = HistoricalNode(f"h{i}", self.d, device="cpu").start()
            self.nodes[h.node_id] = h
        self.client = ClusterClient(
            self.broker,
            nodes={nid: h.url for nid, h in self.nodes.items()},
            replication=replication,
        ).attach()
        self.client.detach()
        self.oracle = self.broker.sql(Q)
        self.client.attach()
        self._qn = 0

    def query(self):
        """One clustered query, result-cache-proof (distinct no-op
        LIMIT per call)."""
        self._qn += 1
        before = self.client.last_metrics
        df = self.broker.sql(Q + f" LIMIT {200 + self._qn}")
        assert self.client.last_metrics is not before, (
            "query did not scatter"
        )
        return df

    def restart(self, node_id):
        """Kill + reboot one historical (fresh context, fresh port —
        a real process restart re-runs snapshot mmap + WAL replay)."""
        self.nodes[node_id].shutdown()
        h = HistoricalNode(node_id, self.d, device="cpu").start()
        self.nodes[node_id] = h
        self.client.set_node_url(node_id, h.url)
        return h

    def close(self):
        self.client.close()
        for h in self.nodes.values():
            h.shutdown()
        self.broker.close()


@pytest.fixture()
def cluster(tmp_path):
    c = _Cluster(tmp_path)
    yield c
    c.close()


# -- single-fault cells -------------------------------------------------------


def test_kill_historical_mid_query_exact_via_replica(cluster):
    from spark_druid_olap_tpu_torch.obs.registry import get_registry

    fo = get_registry().counter(
        "sdol_cluster_failover_total", labels=("node",)
    )
    base = sum(fo.snapshot().values())
    # the serving replica dies INSIDE its handler; the broker must
    # serve the exact answer through the segment's other replica
    injector().arm("cluster.historical_kill", mode="error", times=1)
    df = cluster.query()
    assert cluster.oracle.equals(df)
    assert not df.attrs.get("partial", False)
    assert sum(fo.snapshot().values()) - base >= 1


def test_torn_response_fails_over_exact(cluster):
    # the broker sees half a response body — the strict wire decode
    # must reject it and fail over, never merge garbage
    injector().arm("cluster.torn_response", mode="partial",
                   fraction=0.5, times=1)
    df = cluster.query()
    assert cluster.oracle.equals(df)
    assert not df.attrs.get("partial", False)


def test_rpc_failures_retry_and_fail_over_exact(cluster):
    injector().arm("cluster.rpc", mode="error", times=2)
    df = cluster.query()
    assert cluster.oracle.equals(df)
    assert not df.attrs.get("partial", False)


def test_slow_replica_still_exact(cluster):
    injector().arm("cluster.rpc", mode="delay", delay_ms=80.0, times=1)
    df = cluster.query()
    assert cluster.oracle.equals(df)
    assert not df.attrs.get("partial", False)


# -- replica-set loss ---------------------------------------------------------


def test_all_replicas_lost_serves_coverage_stamped_partial(tmp_path):
    c = _Cluster(tmp_path, n_nodes=2, replication=1)
    try:
        # replication=1: each segment has exactly one home; killing one
        # node loses its replica SETS outright.  The answer must be a
        # stamped partial over the surviving segments — never an error.
        victim = next(iter(c.client.assignment.segment_map.values()))[0]
        c.nodes[victim].shutdown()
        df = c.query()
        assert df.attrs.get("partial") is True
        assert 0.0 <= df.attrs["coverage"] < 1.0
        m = c.broker.last_metrics
        assert m.partial and m.coverage == df.attrs["coverage"]
        # the survivors' rows are still exact: every (city, q, n) row
        # served must match the oracle's row for that city upper-bounded
        merged = df.merge(c.oracle, on="city", suffixes=("", "_full"))
        assert (merged["q"] <= merged["q_full"]).all()
    finally:
        c.close()


def test_every_node_down_partial_not_500(tmp_path):
    c = _Cluster(tmp_path, n_nodes=2, replication=2)
    try:
        for h in c.nodes.values():
            h.shutdown()
        df = c.query()  # no exception: fully degraded, stamped
        assert df.attrs.get("partial") is True
        assert df.attrs["coverage"] == 0.0
    finally:
        c.close()


def test_health_and_metadata_serve_through_open_breakers(tmp_path):
    from spark_druid_olap_tpu_torch.server import OlapServer

    # a cooldown longer than the test: a breaker opened below must still be
    # open when /status/health is read (50 ms could lapse under load)
    c = _Cluster(tmp_path, n_nodes=2, replication=2, cluster_breaker_cooldown_ms=60_000.0)
    srv = OlapServer(c.broker, port=0).start()
    try:
        for h in c.nodes.values():
            h.shutdown()
        for _ in range(3):  # drive both breakers past the threshold
            c.query()
        st = c.client.state()
        assert any(
            n["breaker"]["state"] == "open" for n in st["nodes"].values()
        )
        assert st["segments_lost"] > 0
        # health and metadata keep serving through ANY breaker state
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/status/health", timeout=30
        ) as r:
            doc = json.loads(r.read())
        assert doc["cluster"]["live"] < 2
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/druid/v2/datasources", timeout=30
        ) as r:
            assert "ev" in json.loads(r.read())
    finally:
        srv.shutdown()
        c.close()


# -- rolling restart ----------------------------------------------------------


def test_rolling_restart_every_historical_zero_failed_queries(cluster):
    """Restart every historical, one at a time,
    with queries flowing across each step — all exact, none failed,
    none partial."""
    served = 0
    for node_id in sorted(cluster.nodes):
        cluster.nodes[node_id].shutdown()
        for _ in range(2):  # queries through the downtime window
            df = cluster.query()
            assert cluster.oracle.equals(df)
            assert not df.attrs.get("partial", False)
            served += 1
        cluster.restart(node_id)
        time.sleep(0.08)  # let the down-node's breaker cooldown lapse
        for _ in range(2):  # queries after rejoin
            df = cluster.query()
            assert cluster.oracle.equals(df)
            assert not df.attrs.get("partial", False)
            served += 1
    assert served == 4 * len(cluster.nodes)


# -- replay while serving -------------------------------------------------------


def test_replaying_node_503s_replicas_carry_then_rejoins_identical(
    cluster,
):
    c = cluster
    h0 = c.nodes["h0"]
    # simulate the WAL-replay boot window: the node is up but its
    # storage is mid-recovery — the scatter surface must refuse with
    # 503 + Retry-After (the broker treats it as a failed replica)
    h0.ctx.storage.replay_in_progress = True
    try:
        req = urllib.request.Request(
            h0.url + "/druid/v2/cluster/partial",
            data=json.dumps({"query": {}}).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 503
        assert float(ei.value.headers["Retry-After"]) > 0
        # its replicas carry the traffic meanwhile: exact, not partial
        df = c.query()
        assert c.oracle.equals(df)
        assert not df.attrs.get("partial", False)
    finally:
        h0.ctx.storage.replay_in_progress = False

    # real rejoin: kill + reboot (snapshot mmap + WAL replay) and
    # rebalance — answers must come back byte-identical
    c.restart("h0")
    c.client.rebalance()
    time.sleep(0.08)
    df = c.query()
    assert c.oracle.to_json() == df.to_json()  # byte-identical
    assert not df.attrs.get("partial", False)


def test_restarted_node_serves_replayed_wal_rows(tmp_path):
    """A historical restarted AFTER the broker flushed new rows boots
    the newer snapshot generation and rejoins at the new version."""
    c = _Cluster(tmp_path, n_nodes=2, replication=2)
    try:
        c.broker.append_rows("ev", _cols(n=400, seed=9))
        c.broker.storage.flush("ev")  # new snapshot generation
        # restart both nodes onto the new generation, then rebalance so
        # the assignment pins the new version + segment set
        for nid in sorted(c.nodes):
            c.restart(nid)
        c.client.rebalance()
        time.sleep(0.08)
        c.client.detach()
        oracle2 = c.broker.sql(Q + " LIMIT 151")
        c.client.attach()
        df = c.query()
        assert oracle2.equals(df)
        assert not df.attrs.get("partial", False)
    finally:
        c.close()


# -- tracing under chaos --------------------------------------------------------


def _walk_spans(node, out=None):
    out = [] if out is None else out
    out.append(node)
    for c in node.get("children", ()):
        _walk_spans(c, out)
    return out


def _rpc_spans(doc):
    return [
        s for s in _walk_spans(doc["spans"])
        if s.get("name") == "cluster_rpc"
    ]


def _grafts(span):
    return [
        c for c in span.get("children", ())
        if (c.get("attrs") or {}).get("remote")
    ]


def _assert_single_tree(doc):
    """ONE tree: a single `query` root, every span JSON-renderable, and
    every grafted subtree hanging under a cluster_rpc span."""
    assert doc["spans"]["name"] == "query"
    json.dumps(doc)  # renders end-to-end, no cycles/unserializables
    for s in _walk_spans(doc["spans"]):
        if (s.get("attrs") or {}).get("remote"):
            continue  # remote spans carry their own subtree
        for child in _grafts(s):
            assert s["name"] == "cluster_rpc", (
                "graft outside a cluster_rpc span"
            )
            assert child["attrs"].get("node")


def test_trace_kill_mid_query_single_tree_error_span_plus_graft(cluster):
    injector().arm("cluster.historical_kill", mode="error", times=1)
    df = cluster.query()
    assert cluster.oracle.equals(df)
    doc = cluster.broker.tracer.last_trace_dict()
    _assert_single_tree(doc)
    rpcs = _rpc_spans(doc)
    failed = [s for s in rpcs if s["attrs"].get("error")]
    ok = [s for s in rpcs if s["attrs"].get("outcome") == "ok"]
    assert failed, "killed attempt left no error span"
    assert all(not _grafts(s) for s in failed)
    assert ok and any(_grafts(s) for s in ok)
    for g in (g for s in ok for g in _grafts(s)):
        assert g["name"] == "query" and g["attrs"]["node"]


def test_trace_torn_response_failover_still_one_tree(cluster):
    injector().arm("cluster.torn_response", mode="partial",
                   fraction=0.5, times=1)
    df = cluster.query()
    assert cluster.oracle.equals(df)
    doc = cluster.broker.tracer.last_trace_dict()
    _assert_single_tree(doc)
    rpcs = _rpc_spans(doc)
    assert any(s["attrs"].get("error") for s in rpcs)
    assert any(_grafts(s) for s in rpcs)


def test_trace_hedged_rpc_attempts_marked_and_grafted(tmp_path):
    c = _Cluster(tmp_path, cluster_hedge_ms=5.0)
    try:
        injector().arm("cluster.rpc", mode="delay", delay_ms=120.0,
                       times=1)
        df = c.query()
        assert c.oracle.equals(df)
        doc = c.broker.tracer.last_trace_dict()
        _assert_single_tree(doc)
        rpcs = _rpc_spans(doc)
        assert any(s["attrs"].get("hedge") for s in rpcs), (
            "no hedged attempt span recorded"
        )
        assert any(_grafts(s) for s in rpcs)
    finally:
        c.close()


def test_trace_all_replicas_lost_tree_still_well_formed(tmp_path):
    c = _Cluster(tmp_path, n_nodes=2, replication=1)
    try:
        victim = next(iter(c.client.assignment.segment_map.values()))[0]
        c.nodes[victim].shutdown()
        df = c.query()
        assert df.attrs.get("partial") is True
        doc = c.broker.tracer.last_trace_dict()
        _assert_single_tree(doc)
        dead = [
            s for s in _rpc_spans(doc)
            if s["attrs"].get("node") == victim
        ]
        assert dead and all(s["attrs"].get("error") for s in dead)
        assert all(not _grafts(s) for s in dead)
    finally:
        c.close()


def test_trace_absent_graft_degrades_to_untraced_stub(
    cluster, monkeypatch
):
    # the historical computes a good state but ships no trace payload
    # (size cap, defect, old build): the broker grafts an `untraced`
    # stub and keeps per-node attribution via the receipt side-channel
    from spark_druid_olap_tpu_torch.cluster import wire

    monkeypatch.setattr(wire, "encode_trace", lambda doc, **kw: None)
    cluster.broker.tracer.force_sample_next()
    df = cluster.query()
    assert cluster.oracle.equals(df)
    doc = cluster.broker.tracer.last_trace_dict()
    _assert_single_tree(doc)
    ok = [
        s for s in _rpc_spans(doc)
        if s["attrs"].get("outcome") == "ok"
    ]
    assert ok
    stubs = [g for s in ok for g in _grafts(s)]
    assert stubs and all(
        g["attrs"].get("untraced") for g in stubs
    ), "absent trace payload did not degrade to untraced stubs"
    # the separately-shipped receipt keeps per-node buckets flowing
    nodes = doc["receipt"]["cluster"]["nodes"]
    assert any("device_ms" in b for b in nodes.values())


def test_trace_receipt_accounts_90pct_with_per_node_buckets(cluster):
    cluster.broker.tracer.force_sample_next()
    df = cluster.query()
    assert cluster.oracle.equals(df)
    rc = cluster.broker.tracer.last_trace_dict()["receipt"]
    wall = rc["wall_ms"]
    assert wall > 0
    # at least 90% of the wall attributed for a
    # cluster query (grafted subtrees fold per node, rpc overlay spans
    # never double-count against the scatter wall)
    assert rc["unattributed_ms"] <= 0.10 * wall, rc
    nodes = rc["cluster"]["nodes"]
    assert len(nodes) >= 1
    for nid, b in nodes.items():
        assert b["ok"] >= 1, (nid, b)
        assert "device_ms" in b and "transfer_ms" in b, (nid, b)
        assert b["remote_wall_ms"] > 0, (nid, b)


def test_federated_scrape_with_dead_node_stale_never_500(tmp_path):
    from spark_druid_olap_tpu_torch.server import OlapServer

    c = _Cluster(tmp_path, n_nodes=2, replication=2)
    srv = OlapServer(c.broker, port=0).start()
    try:
        c.nodes["h1"].shutdown()
        df = c.query()  # replica carries it; also seeds a trace
        assert c.oracle.equals(df)
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(
            base + "/status/metrics?cluster=1", timeout=30
        ) as r:
            assert r.status == 200
            text = r.read().decode()
        stale = {
            line.split("{node=\"")[1].split("\"")[0]: line.rsplit(" ", 1)[-1]
            for line in text.splitlines()
            if line.startswith("sdol_cluster_scrape_stale{")
        }
        assert stale["h1"] == "1" and stale["h0"] == "0"
        assert 'node="h0"' in text  # live node's series are labeled
        with urllib.request.urlopen(
            base + "/status/profile?cluster=1", timeout=30
        ) as r:
            assert r.status == 200
            prof = json.loads(r.read())
        assert prof["cluster"] is True
        assert prof["stale"] == ["h1"]
        assert prof["nodes"]["h1"] == {"stale": True}
        assert isinstance(prof["nodes"]["h0"], dict)
        # the grafted cluster trace serves as ONE tree over HTTP too
        qid = c.broker.tracer.last_trace_dict()["query_id"]
        with urllib.request.urlopen(
            base + f"/druid/v2/trace/{qid}", timeout=30
        ) as r:
            doc = json.loads(r.read())
        _assert_single_tree(doc)
        assert _rpc_spans(doc)
    finally:
        srv.shutdown()
        c.close()


def test_parallel_scrape_matches_serial_and_propagates_faults():
    """The broker-pooled scrape fan-out answers
    byte-identically to the serial path (sorted submission + sorted
    fold), stamps unreachable nodes stale, and lets an injected fault
    at `cluster.federate` propagate out of `Future.result()` instead of
    being swallowed as staleness."""
    import http.server
    from concurrent.futures import ThreadPoolExecutor

    from spark_druid_olap_tpu_torch.cluster.federation import (
        merge_prometheus,
        scrape_nodes,
    )
    from spark_druid_olap_tpu_torch.resilience import InjectedFault

    class _H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = (
                "# HELP m x\n# TYPE m counter\n"
                f"m{{port=\"{self.server.server_address[1]}\"}} 1\n"
            ).encode()
            self.send_response(200)
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    servers, nodes = [], {}
    for i in range(3):
        s = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _H)
        threading.Thread(target=s.serve_forever, daemon=True).start()
        servers.append(s)
        nodes[f"h{i}"] = f"http://127.0.0.1:{s.server_address[1]}"
    nodes["zz-dead"] = "http://127.0.0.1:9"  # refused -> stale stamp
    pool = ThreadPoolExecutor(max_workers=4)
    try:
        serial = scrape_nodes(nodes, "/status/metrics", 2.0)
        par = scrape_nodes(nodes, "/status/metrics", 2.0, pool=pool)
        assert list(par) == list(serial) == sorted(nodes)
        assert par == serial
        assert merge_prometheus(dict(par)) == merge_prometheus(
            dict(serial)
        )
        assert par["zz-dead"] is None and par["h0"] is not None

        injector().arm("cluster.federate", mode="error", times=1)
        with pytest.raises(InjectedFault):
            scrape_nodes(nodes, "/status/metrics", 2.0, pool=pool)
    finally:
        injector().disarm()
        pool.shutdown(wait=False)
        for s in servers:
            s.shutdown()
