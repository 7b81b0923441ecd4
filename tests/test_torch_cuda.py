"""The hand-written CUDA kernel, and the sketch ops, on the card.

Every test here needs a CUDA card (the kernel has no CPU mode; the sketch
ops are held against their own CPU runs), carries the `cuda` marker and
skips without one.  The file imports only the PyTorch
port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: mins and maxs exactly equal to the plain version; sums within
rtol 1e-5 (the kernel sums in another order over up to 512K rows); two
launches bit-equal; engine frames on the card against the CPU within the
parity bound rtol 2e-5.  Sketch states (HLL registers, theta hash sets,
quantile samples) and `_rho` on the card are bit-equal to the CPU's, and
so are the sketch columns of the sketch queries' frames.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.exec.engine import Engine
from spark_druid_olap_tpu_torch.exec.lowering import sketch_ops
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.ops import cuda_groupby as cg
from spark_druid_olap_tpu_torch.ops import hll
from spark_druid_olap_tpu_torch.workloads import ssb, tpch

pytestmark = pytest.mark.cuda

SHAPES = [
    (4096, 12, 3, 0, 0),
    (8192, 300, 4, 2, 1),
    (8192, 700, 2, 1, 1),
    (1024, 1, 1, 0, 0),
    (524288, 4096, 4, 1, 1),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mk(R, G, Ms, Mn, Mx, device, seed=0, mask_p=0.8):
    rng = np.random.default_rng(seed)
    mask = rng.random(R) < mask_p
    arrs = (
        rng.integers(0, G, R).astype(np.int32),
        mask,
        (rng.random((R, Ms)) * mask[:, None]).astype(np.float32),
        rng.random((R, Mn + Mx)).astype(np.float32),
        rng.random((R, Mn + Mx)) < 0.9,
    )
    return [torch.from_numpy(a).to(device) for a in arrs]


def _held_to_plain(arrs, G, Mn, Mx):
    before = cg.LAUNCHES
    got = cg.cuda_partial_aggregate(*arrs, num_groups=G, num_min=Mn, num_max=Mx)
    again = cg.cuda_partial_aggregate(*arrs, num_groups=G, num_min=Mn, num_max=Mx)
    want = cg.plain_partial_aggregate(*arrs, G, Mn, Mx)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == before + 2
    for a, b in zip(got, again):
        # bit-identical run to run (NaN compares equal to NaN here)
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].cpu().numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("R,G,Ms,Mn,Mx", SHAPES)
def test_kernel_matches_plain(card, R, G, Ms, Mn, Mx):
    _held_to_plain(_mk(R, G, Ms, Mn, Mx, card, seed=6), G, Mn, Mx)


def _sorted_runs(gid, G, runs):
    """gid in `runs` sorted runs: a time-sorted segment spans a few groups."""
    R = gid.shape[0]
    return np.minimum(np.arange(R) * runs // R + G // 2, G - 1).astype(np.int32)


# (R, G, Ms, Mn, Mx, gid layout): each is a regime or an edge of the design
LAYOUTS = {
    "one_group": (65536, 12, 2, 1, 1, lambda g, G: np.full_like(g, 5)),
    "sorted_runs": (65536, 84, 2, 0, 0, lambda g, G: _sorted_runs(g, G, 2)),
    "sorted_many_runs": (65536, 208, 2, 1, 1, lambda g, G: np.sort(g)),
    "lane_edge": (65536, 48, 2, 0, 0, None),
    "warp_edge_low": (65536, 49, 2, 0, 0, None),
    "warp_edge": (65536, 1024, 2, 0, 0, None),
    "shared_edge": (65536, 1025, 2, 0, 0, None),
    "two_column_blocks": (65536, 12, 8, 1, 1, None),
    "short_last_chunk": (3072, 10, 2, 1, 1, None),
    "shared_short_last_chunk": (5120, 3000, 2, 1, 1, None),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_layouts_match_plain(card, layout):
    R, G, Ms, Mn, Mx, gid_fn = LAYOUTS[layout]
    arrs = _mk(R, G, Ms, Mn, Mx, card, seed=11)
    if gid_fn is not None:
        arrs[0] = torch.from_numpy(gid_fn(arrs[0].cpu().numpy(), G)).to(card)
    geo = cg.geometry(R, G, Ms, Mn + Mx)
    regime = {"lane_edge": "lane", "warp_edge_low": "warp", "warp_edge": "warp",
              "shared_edge": "block", "shared_short_last_chunk": "block"}.get(layout)
    assert regime in (None, geo.regime)
    if layout == "two_column_blocks":
        assert Ms + Mn + Mx > geo.cols
    if "short_last_chunk" in layout:
        assert R % geo.chunk_rows
    _held_to_plain(arrs, G, Mn, Mx)


def test_kernel_nan_in_minmax(card):
    gid, mask, sv, mmv, mmm = _mk(8192, 30, 2, 2, 2, card, seed=12)
    mmv[::97, 1] = float("nan")
    mmv[5::131, 2] = float("nan")
    _held_to_plain([gid, mask, sv, mmv, mmm], 30, 2, 2)
    mins = cg.cuda_partial_aggregate(gid, mask, sv, mmv, mmm, num_groups=30,
                                     num_min=2, num_max=2)[1]
    assert bool(torch.isnan(mins[:, 1]).any())


def test_kernel_all_masked(card):
    gid, mask, sv, mmv, mmm = _mk(2048, 10, 2, 1, 1, card, mask_p=0.0)
    sums, mins, maxs = cg.cuda_partial_aggregate(
        gid, mask, sv, mmv, mmm, num_groups=10, num_min=1, num_max=1
    )
    assert float(sums.abs().sum()) == 0.0
    assert bool(torch.isposinf(mins).all()) and bool(torch.isneginf(maxs).all())


def test_kernel_rejects_bad_inputs(card):
    gid, mask, sv, mmv, mmm = _mk(2048, 8, 2, 1, 1, card)
    kw = dict(num_groups=8, num_min=1, num_max=1)
    with pytest.raises(TypeError):
        cg.cuda_partial_aggregate(gid.long(), mask, sv, mmv, mmm, **kw)
    with pytest.raises(ValueError):
        cg.cuda_partial_aggregate(gid, mask, sv.t().contiguous().t(), mmv, mmm, **kw)
    with pytest.raises(ValueError):
        cg.cuda_partial_aggregate(gid, mask.cpu(), sv, mmv, mmm, **kw)
    with pytest.raises(ValueError):
        cg.cuda_partial_aggregate(gid, mask, sv, mmv, mmm, num_groups=5000,
                                  num_min=1, num_max=1)


def test_engine_on_card_matches_cpu(card):
    cols, dicts = ssb.flat_columns(ssb.gen_tables(0.01, seed=7))
    ssb_ds = ssb.datasource(cols, dicts, rows_per_segment=16384)
    tpch_ds = tpch.datasource(*tpch.flat_columns(tpch.gen_tables(0.01)),
                              rows_per_segment=16384)
    cases = (
        [(ssb_ds, n, q) for n, q in ssb.NATIVE_QUERIES.items()]
        + [(tpch_ds, "q1", tpch.NATIVE_QUERIES["q1"])]
        + [(ssb_ds, "timeseries", ssb.TIMESERIES_QUERY), (ssb_ds, "topn", ssb.TOPN_QUERY)]
    )
    cpu, gpu = Engine(device="cpu"), Engine(device=card)
    for ds, name, q in cases:
        before = cg.LAUNCHES
        got = gpu.execute(q, ds)
        m = gpu.last_metrics
        if m.num_groups <= 4096 and m.segments:
            assert cg.LAUNCHES > before, name
            assert m.strategy == "cuda"
        pd.testing.assert_frame_equal(gpu.execute(q, ds), got, check_exact=True)
        want = cpu.execute(q, ds)
        assert list(got.columns) == list(want.columns) and len(got) == len(want), name
        for c in want.columns:
            if want[c].dtype.kind == "f":
                np.testing.assert_allclose(
                    got[c].to_numpy(np.float64), want[c].to_numpy(np.float64),
                    rtol=2e-5, err_msg=name,
                )
            elif name != "topn" and not name.startswith("q3"):
                # ordered by float aggregates: rows may swap on near-ties
                np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(), name)


SKETCHES = {
    "hll11": A.HyperUnique("s", "a", precision=11),
    "hll4": A.HyperUnique("s", "a", precision=4),
    "theta": A.ThetaSketch("s", "a", size=4096),
    "quantiles": A.QuantilesSketch("s", "v", size=1024),
}


@pytest.mark.parametrize("kind", sorted(SKETCHES))
def test_sketch_ops_on_card_equal_cpu(card, kind):
    agg = SKETCHES[kind]
    ops = sketch_ops(agg)
    states = {"cpu": [], "card": []}
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        R, G = 65536, 250
        arrs = {
            "a": rng.integers(-3, 300_000, R).astype(np.int32),
            "v": (rng.random(R) * 1000).astype(np.float32),
            "gid": rng.integers(0, G, R).astype(np.int32),
            "mask": rng.random(R) < 0.8,
        }
        for where, dev in (("cpu", "cpu"), ("card", card)):
            t = {k: torch.from_numpy(v).to(dev) for k, v in arrs.items()}
            states[where].append(ops.partial(agg, t, t["gid"], t["mask"], G))
    for a, b in zip(states["card"], states["cpu"]):
        assert torch.equal(a.cpu(), b)
    merged = {k: ops.merge_states(*v, agg) for k, v in states.items()}
    assert torch.equal(merged["card"].cpu(), merged["cpu"])


def test_rho_on_card_matches_cpu(card):
    w = np.concatenate([np.arange(max((1 << k) - 8192, 0), (1 << k) + 8192) for k in range(28)])
    h = torch.from_numpy(np.unique(w) << 4)
    assert torch.equal(hll._rho(h.to(card), 4).cpu(), hll._rho(h, 4))


def test_sketch_queries_on_card_match_cpu(card):
    tables = ssb.gen_tables(0.01, seed=11)
    ctxs = {d: TPUOlapContext(device=d) for d in ("cpu", card)}
    for ctx in ctxs.values():
        ssb.register(ctx, tables=tables, rows_per_segment=16384)
    frame = ssb.flat_frame(tables)
    for name, sql in ssb.SKETCH_QUERIES.items():
        before = cg.LAUNCHES
        got, want = ctxs[card].sql(sql), ctxs["cpu"].sql(sql)
        assert cg.LAUNCHES > before, name
        pd.testing.assert_frame_equal(ctxs[card].sql(sql), got, check_exact=True)
        ssb.check_sketch_answer(name, got, ssb.sketch_oracle(frame, name))
        keys = [c for c in want.columns if c != "revenue"]
        got = got.sort_values(keys, na_position="last").reset_index(drop=True)
        want = want.sort_values(keys, na_position="last").reset_index(drop=True)
        pd.testing.assert_frame_equal(got[keys], want[keys], check_exact=True)
        np.testing.assert_allclose(got.revenue, want.revenue, rtol=2e-5, err_msg=name)
