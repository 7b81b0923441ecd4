"""The cluster tier of the PyTorch port (`spark_druid_olap_tpu_torch/cluster/`)
against the JAX package's `tests/test_cluster.py`: a broker and N
historicals over one shared snapshot store, all on the CPU.

The historicals are in-process `HistoricalNode`s (each its own context
booted read-only from the broker's `storage_dir`) behind real `OlapServer`s
on ephemeral ports; the broker is a durable context with a `ClusterClient`
attached.  The port's contexts pin `SessionConfig()` (the card's
constants), so a local answer runs the kernel's plain twin as the
historicals' partials do.

* The wire codec: the port's `encode_state` document is the reference's,
  byte for byte, for the same state, and each package decodes the other's.
* The assignment: `replicas_for`, `build_assignment`, `rebalance` and the
  manifest equal the reference's.
* The scatter: answers equal the local context's (frames equal), deltas are
  residual, the health section, receipts and metrics, `SET` on every
  cluster flag; a DATE_TRUNC group answers on the broker.
* A historical raises without a card unless the CPU is asked for.
* Across packages: a port broker over reference historicals, and a
  reference broker over port historicals, answer a dense GroupBy and an HLL
  query as the all-port cluster does.
"""

import json
import urllib.request

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as jsd
from spark_druid_olap_tpu import cluster as jcluster
from spark_druid_olap_tpu.resilience import injector as jinjector
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.cluster import (
    Assignment,
    ClusterClient,
    HistoricalNode,
    WireDecodeError,
    build_assignment,
    decode_state,
    encode_state,
    load_assignment,
    rebalance,
    replicas_for,
    save_assignment,
)
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.resilience import injector

T0 = int(np.datetime64("2023-01-01", "ms").astype(np.int64))
DAY = 86_400_000


@pytest.fixture(autouse=True)
def _disarm():
    injector().disarm()
    jinjector().disarm()
    yield
    injector().disarm()
    jinjector().disarm()


def _cols(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "city": rng.choice(np.array(["austin", "boston", "chicago", "denver"], dtype=object), n),
        "qty": rng.integers(1, 100, n).astype(np.int64),
        "rev": rng.random(n).astype(np.float32),
        "ts": T0 + rng.integers(0, 30, n) * DAY,
    }


def port_config(d, **kw):
    return SessionConfig(storage_dir=str(d), **kw)


def _register(ctx, n=4000, rows_per_segment=1000):
    ctx.register_table("ev", _cols(n), dimensions=["city"], metrics=["qty", "rev"],
                       time_column="ts", rows_per_segment=rows_per_segment)
    return ctx


def _mk_broker(d, **cfg_kw):
    return _register(TPUOlapContext(port_config(d, **cfg_kw), device="cpu"))


class _Cluster:
    """A port broker and N port historicals (in-process) over one directory."""

    def __init__(self, d, n_nodes=2, replication=2, **cfg_kw):
        self.broker = _mk_broker(d, **cfg_kw)
        self.nodes = {}
        for i in range(n_nodes):
            h = HistoricalNode(f"h{i}", str(d), device="cpu").start()
            self.nodes[h.node_id] = h
        self.client = ClusterClient(self.broker, nodes={nid: h.url for nid, h in self.nodes.items()},
                                    replication=replication).attach()

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


# -- the wire codec ------------------------------------------------------------


def _state(g=5, a=3, m=2, w=8):
    rng = np.random.default_rng(0)
    return {
        "sums": rng.random((g, a)),
        "mins": rng.random((g, m)),
        "maxs": rng.random((g, m)),
        "sketches": {"hll$u": rng.integers(0, 255, (g, w)).astype(np.uint8)},
    }


def test_wire_roundtrip_preserves_dtype_shape_values():
    st = _state()
    doc = encode_state(st)
    # the reference's document, byte for byte, and each decodes the other's
    assert json.dumps(doc, sort_keys=True) == json.dumps(jcluster.encode_state(st), sort_keys=True)
    out = decode_state(json.loads(json.dumps(jcluster.encode_state(st))))
    back = jcluster.decode_state(json.loads(json.dumps(doc)))
    for k in ("sums", "mins", "maxs"):
        assert out[k].dtype == st[k].dtype and back[k].dtype == st[k].dtype
        assert np.array_equal(out[k], st[k]) and np.array_equal(back[k], st[k])
    assert np.array_equal(st["sketches"]["hll$u"], out["sketches"]["hll$u"])
    out["sums"][0, 0] = 7.0  # writable: the merge folds in place


def test_wire_decode_rejects_torn_and_malformed():
    doc = encode_state(_state())
    with pytest.raises(WireDecodeError):
        decode_state(None)
    bad = json.loads(json.dumps(doc))
    bad["sums"]["data"] = bad["sums"]["data"][: len(bad["sums"]["data"]) // 2]
    with pytest.raises(WireDecodeError):
        decode_state(bad)
    bad2 = json.loads(json.dumps(doc))
    bad2["mins"]["shape"] = [999, 999]  # bytes and shape disagree
    with pytest.raises(WireDecodeError):
        decode_state(bad2)
    for d in (bad, bad2):  # the reference rejects the same documents
        with pytest.raises(jcluster.WireDecodeError):
            jcluster.decode_state(d)


# -- the assignment ------------------------------------------------------------


def test_hrw_deterministic_and_clamped():
    nodes = ["h0", "h1", "h2"]
    a = replicas_for("seg-1", nodes, 2)
    assert a == replicas_for("seg-1", list(reversed(nodes)), 2)
    assert len(a) == 2 and len(set(a)) == 2
    assert len(replicas_for("seg-1", ["h0"], 3)) == 1  # clamped
    for i in range(64):  # the reference's chains
        for r in (1, 2, 3):
            assert replicas_for(f"s{i}", nodes, r) == jcluster.replicas_for(f"s{i}", nodes, r)


def test_hrw_minimal_movement_on_membership_change():
    sids = [f"s{i}" for i in range(64)]
    before = {s: replicas_for(s, ["h0", "h1", "h2"], 2) for s in sids}
    after = {s: replicas_for(s, ["h0", "h1"], 2) for s in sids}
    for s in sids:
        kept = [n for n in before[s] if n != "h2"]
        assert all(n in after[s] for n in kept), (s, before[s], after[s])


def test_assignment_rebalance_bumps_epoch_and_persists(tmp_path):
    a = build_assignment({"ev": ["s1", "s2"]}, ["h0", "h1"], 2, versions={"ev": 4})
    assert a.epoch == 1 and a.versions == {"ev": 4}
    b = rebalance(a, ["h0", "h1", "h2"], segment_ids={"ev": ["s1", "s2"]})
    assert b.epoch == 2 and b.versions == {"ev": 4}
    save_assignment(str(tmp_path), b)
    back = load_assignment(str(tmp_path))
    assert back == b and isinstance(back, Assignment)
    # the reference computes the same maps and reads the port's manifest
    jb = jcluster.rebalance(
        jcluster.build_assignment({"ev": ["s1", "s2"]}, ["h0", "h1"], 2, versions={"ev": 4}),
        ["h0", "h1", "h2"], segment_ids={"ev": ["s1", "s2"]})
    assert jb.to_dict() == b.to_dict()
    assert jcluster.load_assignment(str(tmp_path)).to_dict() == b.to_dict()


def test_deficit_counts_under_and_lost():
    a = build_assignment({"ev": ["s1", "s2", "s3"]}, ["h0", "h1"], 2)
    assert a.deficit(["h0", "h1"]) == (0, 0)
    under, lost = a.deficit(["h0"])
    assert under == 3 and lost == 0
    assert a.deficit([]) == (3, 3)


def test_broker_resumes_epoch_from_manifest(tmp_path):
    c = _Cluster(tmp_path)
    try:
        e1 = c.client.assignment.epoch
        c.client.rebalance()
        e2 = c.client.assignment.epoch
        assert e2 == e1 + 1
    finally:
        c.close()
    broker2 = TPUOlapContext(port_config(tmp_path), device="cpu")
    cl2 = ClusterClient(broker2, nodes={"h9": "http://127.0.0.1:1"})
    try:
        assert cl2.assignment.epoch > e2
    finally:
        cl2.close()
        broker2.close()


# -- scatter and gather ----------------------------------------------------------

Q_GROUPBY = (
    "SELECT city, sum(qty) AS q, count(*) AS n, max(rev) AS r "
    "FROM ev GROUP BY city ORDER BY city"
)


def test_cluster_answers_equal_local(cluster):
    c = cluster
    c.client.detach()
    local = c.broker.sql(Q_GROUPBY)
    assert c.client.last_metrics is None  # detached: the local path
    c.client.attach()
    # a no-op LIMIT dodges the result cache and keeps the answer
    out = c.broker.sql(Q_GROUPBY + " LIMIT 100")
    m = c.client.last_metrics
    assert m is not None and m.executor == "cluster"
    assert m.strategy == "cluster" and m.distributed
    assert not m.partial
    assert c.broker.last_metrics is m
    pd.testing.assert_frame_equal(out, local, check_exact=True)
    assert m.segments >= 4


def test_cluster_result_matches_across_aggregates(cluster):
    c = cluster
    for i, q in enumerate([
        "SELECT city, min(rev) AS lo, max(rev) AS hi FROM ev GROUP BY city ORDER BY city",
        "SELECT city, sum(rev) AS s FROM ev WHERE qty > 50 GROUP BY city ORDER BY city",
    ]):
        local = c.broker.sql(q)
        before = c.client.last_metrics
        out = c.broker.sql(q + f" LIMIT {100 + i}")
        assert c.client.last_metrics is not before
        pd.testing.assert_frame_equal(out, local, check_exact=True)


def test_fresh_deltas_are_residual_until_rebalance(cluster):
    c = cluster
    c.broker.append_rows("ev", _cols(n=500, seed=11))
    local = c.broker.sql(Q_GROUPBY)
    before = c.client.last_metrics
    out = c.broker.sql(Q_GROUPBY + " LIMIT 101")
    assert c.client.last_metrics is not before
    pd.testing.assert_frame_equal(out, local, check_exact=True)


def test_health_cluster_section_and_metadata_via_server(cluster):
    from spark_druid_olap_tpu_torch.server import OlapServer

    c = cluster
    srv = OlapServer(c.broker, port=0).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/status/health", timeout=30) as r:
            doc = json.loads(r.read())
        cl = doc["cluster"]
        assert cl["live"] == 2 and cl["epoch"] >= 1
        assert cl["replication_deficit"] == 0
        assert set(cl["nodes"]) == {"h0", "h1"}
        for nd in cl["nodes"].values():
            assert nd["live"] and nd["breaker"]["state"] == "closed"
            assert nd["assigned_segments"] >= 1
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/druid/v2/datasources",
                                    timeout=30) as r:
            assert "ev" in json.loads(r.read())
        # the broker's native route scatters too
        body = json.dumps({"queryType": "groupBy", "dataSource": "ev", "granularity": "all",
                           "dimensions": ["city"], "intervals": ["2023-01-01/2023-03-01"],
                           "aggregations": [{"type": "longSum", "name": "q",
                                             "fieldName": "qty"}]}).encode()
        before = c.client.last_metrics
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/druid/v2", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            rows = json.loads(r.read())
        assert c.client.last_metrics is not before and len(rows) == 4
        want = c.broker.sql("SELECT city, sum(qty) AS q FROM ev GROUP BY city")
        assert sorted((x["event"]["city"], x["event"]["q"]) for x in rows) == sorted(
            zip(want["city"], want["q"]))
    finally:
        srv.shutdown()


def test_broker_receipt_attributes_scatter_gather_merge(cluster):
    c = cluster
    c.broker.tracer.force_sample_next()
    c.broker.sql(Q_GROUPBY + " LIMIT 102")
    assert c.client.last_metrics is not None
    rc = c.broker.tracer.last_trace_dict()["receipt"]
    assert rc.get("scatter_ms", 0) > 0
    assert "gather_ms" in rc and "cluster_merge_ms" in rc
    nodes = rc["cluster"]["nodes"]
    assert nodes and all(b["ok"] >= 1 for b in nodes.values())


def test_cluster_rpc_metrics_published(cluster):
    from spark_druid_olap_tpu_torch.obs.registry import get_registry

    c = cluster
    reg = get_registry()
    ctr = reg.counter("sdol_cluster_scatter_total", labels=("node", "outcome"))
    base = sum(v for k, v in ctr.snapshot().items() if k.endswith(",ok"))
    c.broker.sql(Q_GROUPBY + " LIMIT 103")
    assert c.client.last_metrics is not None
    now = sum(v for k, v in ctr.snapshot().items() if k.endswith(",ok"))
    assert now - base >= 1
    c.client.state()  # publishes the health gauges
    assert reg.gauge("sdol_cluster_historicals_live").labels().value == 2
    assert reg.gauge("sdol_cluster_replication_deficit").labels().value == 0


def test_set_applies_every_cluster_flag(cluster):
    c = cluster
    for flag, value, attr, want in [
        ("cluster_rpc_timeout_ms", 750, "rpc_timeout_s", 0.75),
        ("cluster_rpc_retries", 3, "retries", 3),
        ("cluster_hedge_ms", 20, "hedge_s", 0.02),
        ("cluster_scrape_timeout_ms", 500, "scrape_timeout_s", 0.5),
    ]:
        c.broker.sql(f"SET {flag} = {value}")
        assert getattr(c.client, attr) == pytest.approx(want), flag
    c.broker.sql("SET cluster_breaker_failures = 7")
    c.broker.sql("SET cluster_breaker_cooldown_ms = 123")
    br = c.client._breaker("h0")
    assert br.failure_threshold == 7 and br.cooldown_ms == 123
    epoch = c.client.assignment.epoch
    c.broker.sql("SET cluster_replication = 1")
    assert c.client.assignment.epoch == epoch + 1
    assert {len(ch) for ch in c.client.assignment.segment_map.values()} == {1}
    out = c.broker.sql(Q_GROUPBY + " LIMIT 104")
    c.client.detach()
    pd.testing.assert_frame_equal(out, c.broker.sql(Q_GROUPBY), check_exact=True)


def test_historical_runs_on_the_cpu_only_when_asked(tmp_path, monkeypatch):
    """No card and no device asked for: the historical raises instead of
    serving from the host; `device="cpu"` (the CLI's `--device cpu`) runs."""
    import torch

    from spark_druid_olap_tpu_torch.cluster.historical import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _mk_broker(tmp_path).close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HistoricalNode("h0", str(tmp_path)).start()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--storage-dir", str(tmp_path), "--node-id", "h0"])
    node = HistoricalNode("h0", str(tmp_path), device="cpu").start()
    try:
        assert str(node.ctx.engine.device) == "cpu" and node.ctx.cluster_node_id == "h0"
        assert "ev" in node.ctx.catalog.tables()
    finally:
        node.shutdown()


def test_date_trunc_groups_answer_on_the_broker(cluster):
    """A DATE_TRUNC group is a `__time` dimension whose granularity the wire
    JSON does not carry (in both packages): the port's broker answers it
    itself, equal to the local context's, where the JAX package's broker
    scatters it and loses every replica group to the merge's shape check."""
    c = cluster
    sql = ("SELECT DATE_TRUNC('day', ts) AS d, sum(qty) AS q FROM ev "
           "GROUP BY DATE_TRUNC('day', ts) ORDER BY d")
    rw = c.broker.plan_sql(sql)
    assert not c.client.covers(rw.query, c.broker.catalog.get("ev"))
    before = c.client.last_metrics
    out = c.broker.sql(sql + " LIMIT 100")
    assert c.client.last_metrics is before  # not scattered
    assert len(out) == 30 and "partial" not in out.attrs
    c.client.detach()
    pd.testing.assert_frame_equal(out, c.broker.sql(sql), check_exact=True)


# -- across packages -------------------------------------------------------------

CROSS_QUERIES = {
    "dense": Q_GROUPBY,
    "hll": "SELECT city, APPROX_COUNT_DISTINCT(qty) AS u FROM ev GROUP BY city ORDER BY city",
}


def _port_cluster_answers(d):
    c = _Cluster(d)
    try:
        return {k: c.broker.sql(q + " LIMIT 100") for k, q in CROSS_QUERIES.items()}, \
            c.client.last_metrics
    finally:
        c.close()


@pytest.mark.parametrize("broker", ["port", "reference"])
def test_brokers_serve_over_the_other_packages_historicals(tmp_path, broker):
    want, m = _port_cluster_answers(tmp_path / "port")
    assert m.executor == "cluster"
    d = tmp_path / "mixed"
    if broker == "port":
        b = _mk_broker(d)
        nodes = [jcluster.HistoricalNode(f"h{i}", str(d)).start() for i in range(2)]
        client = ClusterClient(b, nodes={h.node_id: h.url for h in nodes}, replication=2).attach()
    else:
        b = _register(jsd.TPUOlapContext(jsd.SessionConfig(storage_dir=str(d))))
        nodes = [HistoricalNode(f"h{i}", str(d), device="cpu").start() for i in range(2)]
        client = jcluster.ClusterClient(b, nodes={h.node_id: h.url for h in nodes},
                                        replication=2).attach()
    try:
        for name, q in CROSS_QUERIES.items():
            before = client.last_metrics
            got = b.sql(q + " LIMIT 100")
            assert client.last_metrics is not before and client.last_metrics.executor == "cluster"
            assert not client.last_metrics.partial
            pd.testing.assert_frame_equal(got.reset_index(drop=True), want[name],
                                          check_exact=True, check_dtype=False)
    finally:
        client.close()
        for h in nodes:
            h.shutdown()
        if broker == "port":
            b.close()
