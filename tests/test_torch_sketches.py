"""Sketch ops of the PyTorch port against the JAX reference, bit for bit.

* `mix32`, `hash_column` (every dtype branch, edge values) and
  `combine_hashes` give the reference's uint32 hashes.
* `_rho` gives the reference's value over all of w < 2^21 (p = 11) and over
  ±8192 windows around every power of two below 2^28 (p = 4), where the
  reference's float32 log2 is off by one; the exception table committed in
  `ops/hll.py` is regenerated from the reference and compared.
* HLL, theta and quantile partial states and their merges equal the
  reference's, through `to_reference_state`: random rows, every row masked,
  out-of-range group ids, tied quantile priorities, CardinalityAgg byRow and
  union-of-fields.  Estimates and theta set operations agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_druid_olap_tpu  # noqa: F401  (the reference's x64 mode)
from spark_druid_olap_tpu.models import aggregations as JA
from spark_druid_olap_tpu.ops import hll as jhll
from spark_druid_olap_tpu.ops import quantiles as jq
from spark_druid_olap_tpu.ops import theta as jtheta
from spark_druid_olap_tpu.utils import hashing as jhash
from spark_druid_olap_tpu_torch.models import aggregations as TA
from spark_druid_olap_tpu_torch.ops import hll as thll
from spark_druid_olap_tpu_torch.ops import quantiles as tq
from spark_druid_olap_tpu_torch.ops import theta as ttheta
from spark_druid_olap_tpu_torch.utils import hashing as thash

DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.bool_, np.float16, np.float32]


def _column(dtype, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if np.dtype(dtype).kind == "f":
        edge = [0.0, -0.0, 1.0, -1.5, np.inf, -np.inf, 65504.0]
        edge += [2.0**31] if dtype == np.float32 else []
        vals = rng.standard_normal(n) * 1000
        return np.concatenate([vals, edge]).astype(dtype)
    info = np.iinfo(dtype)
    edge = [0, info.max, info.min, -1 if info.min < 0 else 1]
    if dtype == np.int64:
        edge += [2**31, 2**32 - 1, 2**32, -(2**31), 0xFFFFFFFF << 7]
    vals = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    return np.concatenate([vals, np.array(edge, dtype=dtype)])


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_hash_column_matches_reference(dtype):
    col = _column(dtype)
    for seed in (0, 7, 11, 13):
        want = np.asarray(jhash.hash_column(jnp.asarray(col), seed)).astype(np.int64)
        got = thash.hash_column(torch.from_numpy(col), seed).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")


def test_mix32_and_combine_match_reference():
    rng = np.random.default_rng(1)
    u = np.concatenate([
        rng.integers(0, 2**32, 4000, dtype=np.uint64),
        np.array([0, 1, 2**31, 2**31 - 1, 0xFFFFFFFF], dtype=np.uint64),
    ]).astype(np.uint32)
    t = torch.from_numpy(u.astype(np.int64))
    for seed in (0, 1, 7):
        want = np.asarray(jhash.mix32(jnp.asarray(u), seed)).astype(np.int64)
        np.testing.assert_array_equal(thash.mix32(t, seed).numpy(), want)
        want_np = jhash.mix32_np(u, seed).astype(np.int64)
        np.testing.assert_array_equal(thash.mix32(t, seed).numpy(), want_np)
    hs = [u[i::3][:1000] for i in range(3)]
    want = np.asarray(jhash.combine_hashes([jnp.asarray(h) for h in hs]))
    got = thash.combine_hashes([torch.from_numpy(h.astype(np.int64)) for h in hs])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _windows(top_bits=28, half=8192):
    w = np.concatenate([
        np.arange(max((1 << k) - half, 0), min((1 << k) + half, 1 << top_bits))
        for k in range(top_bits)
    ])
    return np.unique(w)


def _runs(w, lg):
    runs = []
    for a, v in zip(w.tolist(), lg.tolist()):
        if runs and runs[-1][1] == a - 1 and runs[-1][2] == v:
            runs[-1][1] = a
        else:
            runs.append([a, a, v])
    return [tuple(r) for r in runs]


@pytest.mark.parametrize("p,domain", [(11, "all"), (4, "windows")])
def test_rho_matches_reference_and_exception_table(p, domain):
    w = np.arange(1 << (32 - p)) if domain == "all" else _windows(32 - p)
    low = np.random.default_rng(p).integers(0, 1 << p, len(w))
    h = ((w.astype(np.uint64) << np.uint64(p)) | low.astype(np.uint64)).astype(np.uint32)
    want = np.asarray(jhll._rho(jnp.asarray(h), p))
    got = thll._rho(torch.from_numpy(h.astype(np.int64)), p).numpy()
    np.testing.assert_array_equal(got, want)
    # the reference's floor(log2 w) where it differs from the exact one
    # over this domain, as runs, against the committed table's runs there
    lg = (32 - p) - want.astype(np.int64)
    exact = np.frexp(np.maximum(w, 1).astype(np.float32))[1] - 1
    off = (w > 0) & (lg != exact)
    covered = np.isin(
        np.concatenate([np.arange(a, b + 1) for a, b, _ in thll._LOG2_EXCEPTIONS]), w
    )
    table = np.concatenate([
        np.stack([np.arange(a, b + 1), np.full(b - a + 1, v)], axis=1)
        for a, b, v in thll._LOG2_EXCEPTIONS
    ])[covered]
    assert _runs(w[off], lg[off]) == _runs(table[:, 0], table[:, 1])
    if p == 11:  # the reference's rho of 0 at w = 2^21 - 1 is kept
        assert got[w == (1 << 21) - 1].tolist() == [0]


# -- partial states and merges ------------------------------------------------

R, G = 4096, 13


def _rows(seed, masked=False):
    """Segment-like rows: group ids (a few out of range), a row mask and
    three columns."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(-1, G + 1, R).astype(np.int32)
    mask = np.zeros(R, bool) if masked else rng.random(R) < 0.8
    cols = {
        "a": rng.integers(-5, 3000, R).astype(np.int32),
        "b": rng.integers(0, 40, R).astype(np.int8),
        "v": (rng.random(R) * 100).astype(np.float32),
    }
    return gid, mask, cols


def _run_both(kind, seed, masked=False):
    """(reference state, port state, port aggregation)."""
    gid, mask, cols = _rows(seed, masked)
    jc = {k: jnp.asarray(v) for k, v in cols.items()}
    tc = {k: torch.from_numpy(v) for k, v in cols.items()}
    jargs = (jnp.asarray(gid), jnp.asarray(mask), G)
    targs = (torch.from_numpy(gid), torch.from_numpy(mask), G)
    if kind.startswith("hll"):
        p = 4 if kind == "hll_p4" else 11
        if kind == "hll_byrow":
            ja, ta = (x.CardinalityAgg("c", ("a", "b"), by_row=True) for x in (JA, TA))
        elif kind == "hll_union":
            ja, ta = (x.CardinalityAgg("c", ("a", "b")) for x in (JA, TA))
        else:
            ja, ta = (x.HyperUnique("u", "a", precision=p) for x in (JA, TA))
        return (np.asarray(jhll.partial_hll(ja, jc, *jargs)),
                thll.partial_hll(ta, tc, *targs), ta)
    if kind == "theta":
        ja, ta = (x.ThetaSketch("t", "a", size=64) for x in (JA, TA))
        return (np.asarray(jtheta.partial_theta(ja, jc, *jargs)),
                ttheta.partial_theta(ta, tc, *targs), ta)
    if kind == "quantiles":
        ja, ta = (x.QuantilesSketch("q", "v", size=32) for x in (JA, TA))
        return (np.asarray(jq.partial_quantiles(ja, jc, *jargs)),
                tq.partial_quantiles(ta, tc, *targs), ta)
    # tied priorities: 30 distinct priorities over 4096 rows, K = 16
    prio = np.random.default_rng(seed + 100).integers(0, 30, R).astype(np.int32)
    v = cols["v"]
    want = jq._bottom_k_pairs(jnp.asarray(prio), jnp.asarray(v), *jargs[:2], G, 16)
    got = tq._bottom_k_pairs(
        torch.from_numpy(prio.astype(np.int64)), torch.from_numpy(v), *targs[:2], G, 16
    )
    return np.asarray(want), got, TA.QuantilesSketch("q", "v", size=16)


_OPS = {"theta": (jtheta, ttheta), "quantiles": (jq, tq), "quantile_ties": (jq, tq)}


@pytest.mark.parametrize(
    "kind", ["hll", "hll_p4", "hll_byrow", "hll_union", "theta", "quantiles", "quantile_ties"]
)
@pytest.mark.parametrize("masked", [False, True], ids=["rows", "all_masked"])
def test_partials_and_merge_match_reference(kind, masked):
    jmod, tmod = _OPS.get(kind, (jhll, thll))
    ja, ta, agg = _run_both(kind, 1, masked)
    jb, tb, _ = _run_both(kind, 2)
    for want, got in ((ja, ta), (jb, tb)):
        assert want.dtype == tmod.to_reference_state(got).dtype
        np.testing.assert_array_equal(tmod.to_reference_state(got), want)
        np.testing.assert_array_equal(
            tmod.to_reference_state(tmod.from_reference_state(want)), want
        )
    if tmod is thll:
        want = np.maximum(ja, jb)
    else:
        k = ja.shape[1] - (tmod is tq)
        want = np.asarray(jmod.merge_many([jnp.asarray(ja), jnp.asarray(jb)], k))
    got = tmod.merge_states(ta, tb, agg)
    np.testing.assert_array_equal(tmod.to_reference_state(got), want)
    if masked:  # nothing kept: the merge identity
        empty = tmod.to_reference_state(tmod.empty_state(agg, G, "cpu"))
        np.testing.assert_array_equal(empty, ja)


def test_estimates_and_set_ops_match_reference():
    h1 = _run_both("hll", 3)[0]
    np.testing.assert_array_equal(thll.estimate(h1), jhll.estimate(h1))
    states = [_run_both("theta", s)[0] for s in (3, 4, 5)]
    np.testing.assert_array_equal(ttheta.estimate(states[0]), jtheta.estimate(states[0]))
    for fn in ("UNION", "INTERSECT", "NOT"):
        np.testing.assert_array_equal(
            ttheta.set_op_estimate(fn, states), jtheta.set_op_estimate(fn, states)
        )
    qs = _run_both("quantiles", 3)[0]
    for frac in (0.0, 0.5, 0.9):
        np.testing.assert_array_equal(tq.estimate(qs, frac), jq.estimate(qs, frac))
    np.testing.assert_array_equal(tq.count(qs), jq.count(qs))


def test_quantile_rank_error():
    from spark_druid_olap_tpu_torch.workloads.ssb import quantile_rank_error

    v = np.array([1.0, 2.0, 2.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0])
    assert quantile_rank_error(v, 2.0, 0.2) == 0.0  # ties span ranks 0.1-0.4
    assert quantile_rank_error(v, 2.0, 0.5) == pytest.approx(0.1)
    assert quantile_rank_error(v, 6.5, 0.5) == pytest.approx(0.3)
    assert quantile_rank_error(v, 0.5, 0.1) == pytest.approx(0.1)
