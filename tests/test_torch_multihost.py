"""Processes over `torch.distributed` (`parallel/multihost.py`) against the
JAX package's `tests/test_multihost.py`.

* The rendezvous is safe to call unconditionally: no markers is a no-op, a
  lone marker (or one without the rest of the environment) stays one
  process, and an explicit rendezvous missing a part raises.
* `local_segments` deals segments round-robin by rank; `local_rows` builds
  a process's rows alone, equal to the slice of the whole concatenation.
* Real process groups: 2 x 4 and 4 x 2 processes x logical CPU devices over
  gloo on 127.0.0.1, spawned from this file's `__main__`.  Each rank builds
  the same datasources from one numpy seed, places only its own rows and
  runs a dense GroupBy on the arena and on the row-shard path, HLL, theta
  and quantile sketches, the sparse tier and the adaptive tier.  Every
  rank's frame is bit-identical to the others' and to the one-process
  P-slice x D slice mesh under the hierarchical tree; every rank's resident
  bytes are 1/P of that mesh's.  Against the JAX package's single-process
  engine: keys, counts, HLL, theta and quantile results exact, sums within
  rtol 1e-6 (the merge adds the shards' states in another order).
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from spark_druid_olap_tpu_torch.catalog.segment import DimensionDict, build_datasource
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.parallel import mesh as tmesh
from spark_druid_olap_tpu_torch.parallel import multihost
from spark_druid_olap_tpu_torch.parallel.distributed import DistributedEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
N = 8192
# (case, datasource, strategy, arena on)
CASES = (
    ("dense_arena", "mh", "dense", True),
    ("dense_rows", "mh", "dense", False),
    ("sketches", "mhsk", "dense", True),
    ("sparse", "mhhc", "sparse", True),
    ("adaptive", "mhad", "adaptive", True),
)


def _columns():
    """The reference test's data, drawn in its order from one seed."""
    rng = np.random.default_rng(3)
    g = rng.integers(0, 7, N).astype(np.int64)
    v = rng.random(N).astype(np.float32)
    k = rng.integers(0, 3000, N).astype(np.int64)
    lat = rng.gamma(2.0, 10.0, N).astype(np.float32)
    da = db = 300
    pairs = rng.choice(da * db, size=800, replace=False)
    pick = pairs[rng.integers(0, 800, N)]
    # the adaptive tier's: 40 x 50 codes present of a 300 x 300 domain
    ad_a = rng.choice(da, size=40, replace=False)[rng.integers(0, 40, N)].astype(np.int64)
    ad_b = rng.choice(db, size=50, replace=False)[rng.integers(0, 50, N)].astype(np.int64)
    return {
        "mh": dict(columns={"g": g, "v": v}, dimension_cols=["g"], metric_cols=["v"],
                   rows_per_segment=1024),
        "mhsk": dict(columns={"g": g, "v": v, "k": k, "lat": lat}, dimension_cols=["g"],
                     metric_cols=["v", "k", "lat"], rows_per_segment=1024),
        "mhhc": dict(columns={"a": (pick // db).astype(np.int64),
                              "b": (pick % db).astype(np.int64), "v": v},
                     dimension_cols=["a", "b"], metric_cols=["v"], rows_per_segment=2048,
                     dicts={"a": tuple(range(da)), "b": tuple(range(db))}),
        "mhad": dict(columns={"a": ad_a, "b": ad_b, "v": v}, dimension_cols=["a", "b"],
                     metric_cols=["v"], rows_per_segment=1024,
                     dicts={"a": tuple(range(da)), "b": tuple(range(db))}),
    }


def datasources(build, dict_type):
    out = {}
    for name, spec in _columns().items():
        spec = dict(spec)
        if "dicts" in spec:
            spec["dicts"] = {c: dict_type(values=vals) for c, vals in spec["dicts"].items()}
        out[name] = build(name, spec.pop("columns"), **spec)
    return out


def query(case, models):
    """The case's query, built from either package's model modules."""
    agg, dims, Q = models
    if case in ("sparse", "adaptive"):
        return Q.GroupByQuery(datasource="mhhc" if case == "sparse" else "mhad",
                              dimensions=(dims.DimensionSpec("a"), dims.DimensionSpec("b")),
                              aggregations=(agg.Count("n"), agg.DoubleSum("s", "v")))
    if case == "sketches":
        return Q.GroupByQuery(
            datasource="mhsk", dimensions=(dims.DimensionSpec("g"),),
            aggregations=(agg.HyperUnique("hll", "k"), agg.ThetaSketch("theta", "k"),
                          agg.QuantilesSketch("qn", "lat"), agg.Count("n")),
            post_aggregations=(agg.QuantileFromSketch("p50", "qn", 0.5),))
    return Q.GroupByQuery(datasource="mh", dimensions=(dims.DimensionSpec("g"),),
                          aggregations=(agg.DoubleSum("s", "v"), agg.Count("n"),
                                        agg.DoubleMin("lo", "v"), agg.DoubleMax("hi", "v")))


def _port_models():
    from spark_druid_olap_tpu_torch.models import dimensions, query as Q

    return A, dimensions, Q


def hierarchical(cfg: SessionConfig) -> SessionConfig:
    """Rates under which a slice mesh's cost model picks the hierarchical
    tree (a fast collective within a slice, a slow link between slices)."""
    return dataclasses.replace(cfg, collective_bytes_per_us=1e9, dcn_bytes_per_us=1e3)


def run_cases(mesh) -> dict:
    """Every case on `mesh`, one engine per strategy (the CPU's cost
    constants on any device); each case's frame and the engine's resident
    bytes after it."""
    ds = datasources(build_datasource, DimensionDict)
    engines = {}
    out = {}
    for case, name, strategy, arena_on in CASES:
        eng = engines.get(strategy)
        if eng is None:
            eng = engines[strategy] = DistributedEngine(mesh, strategy=strategy)
            eng.cost_config = hierarchical(SessionConfig.load_calibrated(device="cpu"))
        eng.arena_execution = arena_on
        df = eng.execute(query(case, _port_models()), ds[name])
        out[case] = {"frame": df, "resident": eng.bytes_resident(),
                     "strategy": eng.last_metrics.strategy,
                     "merge_tree": eng.last_metrics.merge_tree}
    return out


def worker(port: int, rank: int, nproc: int, ndev: int, out: str, device: str = "cpu") -> None:
    """One rank of a real process group over gloo: the rendezvous, the
    cases on the hybrid mesh over `ndev` x `device` (logical devices), the
    results pickled."""
    assert multihost.initialize(f"127.0.0.1:{port}", nproc, rank, backend="gloo")
    assert multihost.initialize()  # a second call is a no-op
    mesh = multihost.hybrid_mesh(devices=[device] * ndev)
    res = run_cases(mesh)
    res["info"] = multihost.process_info(devices=[device] * ndev)
    res["mesh"] = mesh.describe()
    ds = datasources(build_datasource, DimensionDict)["mh"]
    res["local_segments"] = [s.segment_id for s in multihost.local_segments(ds.segments)]
    pd.to_pickle(res, out)
    multihost.shutdown()


# -- the rendezvous -----------------------------------------------------------


def _clear_markers(monkeypatch):
    for k in multihost.MARKERS + ("MASTER_PORT", "RANK", "WORLD_SIZE", "SLURM_PROCID",
                                  "SLURM_NTASKS", "OMPI_COMM_WORLD_RANK"):
        monkeypatch.delenv(k, raising=False)


def test_initialize_is_a_safe_noop_without_markers(monkeypatch):
    _clear_markers(monkeypatch)
    assert multihost.initialize() is False
    assert multihost.initialize() is False  # and stays so
    info = multihost.process_info(devices=["cpu"] * 8)
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_devices"] == 8


@pytest.mark.parametrize("env", [
    {"SLURM_JOB_ID": "42"},  # an interactive allocation: no task variables
    {"OMPI_COMM_WORLD_SIZE": "2"},  # no rank and no address
    {"MASTER_ADDR": "127.0.0.1", "RANK": "0", "WORLD_SIZE": "2"},  # no port
])
def test_a_lone_marker_stays_single_process(monkeypatch, env):
    _clear_markers(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost.initialize() is False
    assert multihost.process_count() == 1


def test_an_explicit_rendezvous_missing_a_part_raises(monkeypatch):
    _clear_markers(monkeypatch)
    with pytest.raises(ValueError, match="address"):
        multihost.initialize(num_processes=2, process_id=0)


def test_hybrid_mesh_in_one_process_equals_make_mesh():
    m = multihost.hybrid_mesh(n_groups=2, devices=["cpu"] * 8)
    assert m.shape == tmesh.make_mesh(n_groups=2, devices=["cpu"] * 8).shape
    assert m.processes == 1
    assert multihost.owned(4, 1, 0) == range(4) and multihost.owned(8, 4, 2) == range(4, 6)


def test_local_segments_partition(monkeypatch):
    segs = list(range(10))
    assert multihost.local_segments(segs) == segs  # one process: all
    monkeypatch.setattr(multihost, "process_count", lambda: 3)
    owned = []
    for pi in range(3):
        monkeypatch.setattr(multihost, "process_index", lambda pi=pi: pi)
        got = multihost.local_segments(segs)
        if pi == 1:
            assert got == [1, 4, 7]
        owned += got
    assert sorted(owned) == segs  # every segment held by exactly one process


@pytest.mark.parametrize("lo,hi", [(0, 1024), (1000, 3000), (7000, 9000), (9000, 10240)])
def test_local_rows_are_the_slice_of_the_concatenation(lo, hi):
    ds = datasources(build_datasource, DimensionDict)["mhhc"]
    whole = np.concatenate([np.asarray(s.column("a")) for s in ds.segments])
    padded = np.concatenate([whole, np.full(10240 - len(whole), -1, dtype=whole.dtype)])
    got = multihost.local_rows(ds.segments, lambda s: s.column("a"), lo, hi, -1)
    np.testing.assert_array_equal(got, padded[lo:hi])


# -- real process groups -------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(tmp_path, nproc: int, ndev: int, device: str = "cpu") -> list:
    """`nproc` ranks of `worker` over `ndev` x `device` each; their results."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    outs = [str(tmp_path / f"rank{i}.pkl") for i in range(nproc)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(i),
                               str(nproc), str(ndev), outs[i], device],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(nproc)]
    try:
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {i} failed:\n{err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [pd.read_pickle(o) for o in outs]


def _reference_frames():
    """The JAX package's single-process engine on the same data."""
    from spark_druid_olap_tpu.catalog.segment import DimensionDict as JDict
    from spark_druid_olap_tpu.catalog.segment import build_datasource as jbuild
    from spark_druid_olap_tpu.exec.engine import Engine as JEngine
    from spark_druid_olap_tpu.models import aggregations as jagg
    from spark_druid_olap_tpu.models import dimensions as jdims
    from spark_druid_olap_tpu.models import query as jq

    ds = datasources(jbuild, JDict)
    out = {}
    for case, name, strategy, _ in CASES:
        strat = "sparse" if case == "sparse" else "auto"
        out[case] = JEngine(strategy=strat).execute(query(case, (jagg, jdims, jq)), ds[name])
    return out


def _sorted(df, keys):
    return df.sort_values(keys).reset_index(drop=True)


def _against_reference(case, got, want):
    keys = ["a", "b"] if case in ("sparse", "adaptive") else ["g"]
    got, want = _sorted(got, keys), _sorted(want, keys)
    assert list(got[keys].astype(str).itertuples(index=False)) == \
        list(want[keys].astype(str).itertuples(index=False))
    exact = {"n", "hll", "theta", "qn", "p50", "lo", "hi"} & set(want.columns)
    for c in sorted(exact):
        np.testing.assert_array_equal(np.asarray(got[c], dtype=np.float64),
                                      np.asarray(want[c], dtype=np.float64), err_msg=c)
    if "s" in want.columns:
        np.testing.assert_allclose(np.asarray(got["s"], dtype=np.float64),
                                   np.asarray(want["s"], dtype=np.float64), rtol=RTOL)


@pytest.mark.parametrize("nproc,ndev", [(2, 4), (4, 2)])
def test_true_multi_process_mesh(tmp_path, nproc, ndev):
    ranks = spawn(tmp_path, nproc, ndev)
    single = run_cases(tmesh.make_slice_mesh(nproc, ndev, ["cpu"] * (nproc * ndev)))
    ref = _reference_frames()
    segs = datasources(build_datasource, DimensionDict)["mh"].segments
    dealt = []
    for r, res in enumerate(ranks):
        assert res["info"]["process_count"] == nproc and res["info"]["process_index"] == r
        assert res["info"]["global_devices"] == nproc * ndev
        assert res["mesh"]["axes"] == {"slice": nproc, "data": ndev}
        dealt += res["local_segments"]
        for case, *_ in CASES:
            got, want = res[case], single[case]
            # the same bits on every rank, and as the one-process slice mesh
            pd.testing.assert_frame_equal(got["frame"], want["frame"], check_exact=True)
            assert got["strategy"] == want["strategy"] == {
                "sparse": "sparse", "adaptive": "adaptive"}.get(case, "dense")
            # the dense states merge slice by slice; the sparse tier folds its
            # gathered states in shard order (its metrics name no tree)
            assert got["merge_tree"] == want["merge_tree"] == (
                "" if case == "sparse" else "hierarchical")
            # only its own rows: 1/P of the one-process mesh's residency
            assert got["resident"] * nproc == want["resident"] > 0, case
    assert sorted(dealt) == sorted(s.segment_id for s in segs)
    for case, *_ in CASES:
        _against_reference(case, ranks[0][case]["frame"], ref[case])


if __name__ == "__main__":
    worker(*(int(x) for x in sys.argv[1:5]), *sys.argv[5:7])
