"""Group-by partial aggregation: the PyTorch port against the JAX reference.

The same inputs, made with numpy from a seed, go through the reference's
`dense_partial_aggregate`, `pallas_partial_aggregate` (interpret mode) and
`scatter_partial_aggregate`, and through the port's `plain_partial_aggregate`,
`dense_partial_aggregate`, `scatter_partial_aggregate` and the kernel wrapper
on CPU tensors.  Tolerance: sums rtol 1e-6 (the block order is the same,
float32 products may round differently inside a block); mins, maxs and
counts exact.  The kernel itself runs only on a card: its tests are in
`test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_druid_olap_tpu.ops import groupby as jgb
from spark_druid_olap_tpu.ops.pallas_groupby import pallas_partial_aggregate
from spark_druid_olap_tpu_torch.ops import cuda_groupby as cg
from spark_druid_olap_tpu_torch.ops import groupby as tgb

# the reference kernel's test shapes, plus one above the dense cutover
SHAPES = [
    (4096, 12, 3, 0, 0),
    (8192, 300, 4, 2, 1),
    (8192, 700, 2, 1, 1),
    (1024, 1, 1, 0, 0),
]
BIG_G = (4096, 5000, 2, 1, 1)


def _mk(R, G, Ms, Mn, Mx, seed=0, mask_p=0.8):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, G, R).astype(np.int32)
    mask = rng.random(R) < mask_p
    sv = (rng.random((R, Ms)) * mask[:, None]).astype(np.float32)
    mmv = rng.random((R, Mn + Mx)).astype(np.float32)
    mmm = rng.random((R, Mn + Mx)) < 0.9
    return gid, mask, sv, mmv, mmm


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


def _torch(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _check(got, want, rtol=1e-6):
    s, mn, mx = (np.asarray(x) for x in got)
    ws, wmn, wmx = (np.asarray(x) for x in want)
    assert s.dtype == mn.dtype == mx.dtype == np.float32
    np.testing.assert_allclose(s, ws, rtol=rtol)
    np.testing.assert_array_equal(mn, wmn)
    np.testing.assert_array_equal(mx, wmx)


@pytest.mark.parametrize("R,G,Ms,Mn,Mx", SHAPES)
def test_dense_matches_reference(R, G, Ms, Mn, Mx):
    arrs = _mk(R, G, Ms, Mn, Mx)
    kw = dict(num_groups=G, block_rows=1024, num_min=Mn, num_max=Mx)
    want = jgb.dense_partial_aggregate(*_jax(arrs), **kw)
    _check(tgb.dense_partial_aggregate(*_torch(arrs), **kw), want)


@pytest.mark.parametrize("R,G,Ms,Mn,Mx", SHAPES)
def test_plain_matches_pallas_reference(R, G, Ms, Mn, Mx):
    arrs = _mk(R, G, Ms, Mn, Mx, seed=1)
    want = pallas_partial_aggregate(
        *_jax(arrs), num_groups=G, num_min=Mn, num_max=Mx, interpret=True
    )
    _check(cg.plain_partial_aggregate(*_torch(arrs), G, Mn, Mx), want)


@pytest.mark.parametrize("R,G,Ms,Mn,Mx", SHAPES)
def test_wrapper_on_cpu_is_plain(R, G, Ms, Mn, Mx):
    arrs = _torch(_mk(R, G, Ms, Mn, Mx, seed=2))
    before = cg.LAUNCHES
    got = cg.cuda_partial_aggregate(*arrs, num_groups=G, num_min=Mn, num_max=Mx)
    want = cg.plain_partial_aggregate(*arrs, G, Mn, Mx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert cg.LAUNCHES == before  # CPU tensors never count as launches


@pytest.mark.parametrize("R,G,Ms,Mn,Mx", SHAPES + [BIG_G])
def test_scatter_matches_reference(R, G, Ms, Mn, Mx):
    arrs = _mk(R, G, Ms, Mn, Mx, seed=3)
    kw = dict(num_groups=G, num_min=Mn, num_max=Mx)
    want = jgb.scatter_partial_aggregate(*_jax(arrs), **kw)
    _check(tgb.scatter_partial_aggregate(*_torch(arrs), **kw), want, rtol=1e-5)


def test_all_masked_gives_identities():
    gid, mask, sv, mmv, mmm = _mk(2048, 10, 2, 1, 1, mask_p=0.0)
    args = _torch([gid, np.zeros_like(mask), sv * 0, mmv, mmm])
    for fn in (
        lambda: cg.plain_partial_aggregate(*args, 10, 1, 1),
        lambda: tgb.scatter_partial_aggregate(
            *args, num_groups=10, num_min=1, num_max=1
        ),
    ):
        sums, mins, maxs = fn()
        assert float(sums.abs().sum()) == 0.0
        assert torch.isinf(mins).all() and (mins > 0).all()
        assert torch.isinf(maxs).all() and (maxs < 0).all()


def test_partial_aggregate_dispatch():
    arrs = _torch(_mk(*BIG_G, seed=4))
    assert tgb.resolve_strategy("auto", 4096, "cpu") == "dense"
    assert tgb.resolve_strategy("auto", 4096, "cuda") == "cuda"
    assert tgb.resolve_strategy("auto", 4097, "cuda") == "segment"
    got = tgb.partial_aggregate(*arrs, num_groups=5000, num_min=1, num_max=1)
    want = tgb.scatter_partial_aggregate(*arrs, num_groups=5000, num_min=1, num_max=1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_combine_group_ids_widens_narrow_codes():
    rng = np.random.default_rng(5)
    a = rng.integers(-1, 120, 4096).astype(np.int8)
    b = rng.integers(-1, 3000, 4096).astype(np.int16)
    want, wg = jgb.combine_group_ids([jnp.asarray(a), jnp.asarray(b)], [120, 3000])
    got, g = tgb.combine_group_ids([torch.from_numpy(a), torch.from_numpy(b)], [120, 3000])
    assert g == wg == 360000
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_choose_block_rows_matches_reference():
    for R, G in [(524288, 1), (524288, 208), (524288, 4096), (1024, 12)]:
        assert tgb.choose_block_rows(R, G) == jgb.choose_block_rows(R, G)


def test_chunk_rows_fill_the_card_within_limits():
    for R, G, M in [(524288, 1, 6), (524288, 12, 12), (524288, 4096, 6), (1024, 5, 1)]:
        rows = cg.chunk_rows_for(R, G, M)
        assert rows % 1024 == 0 and 1024 <= rows <= 8192


def test_wrapper_rejects_other_devices():
    arrs = [t.to("meta") for t in _torch(_mk(1024, 4, 1, 0, 0))]
    with pytest.raises(ValueError, match="no kernel for device"):
        cg.cuda_partial_aggregate(*arrs, num_groups=4, num_min=0, num_max=0)
