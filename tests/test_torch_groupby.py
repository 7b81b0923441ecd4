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


# (R, G, Ms, Mn+Mx): the main path's segment shapes and the edges
GEOMETRY_SHAPES = [
    (524288, 1, 2, 0), (524288, 12, 8, 0), (524288, 84, 2, 0),
    (524288, 208, 4, 2), (524288, 4096, 4, 2), (524288, 4096, 8, 2),
    (524288, 4096, 40, 20), (3072, 10, 2, 2), (1024, 5, 1, 0), (0, 3, 1, 0),
]


def test_chunk_rows_fill_the_card_within_limits():
    for R, G, Ms, Mnx in GEOMETRY_SHAPES:
        geo = cg.geometry(R, G, Ms, Mnx)
        assert geo.chunk_rows % geo.tile_rows == 0 and geo.tile_rows % 256 == 0
        assert geo.n_chunks * geo.chunk_rows >= R > (geo.n_chunks - 1) * geo.chunk_rows
        assert 1 <= geo.cols <= 8 and geo.cols <= max(Ms + Mnx, 1)
        assert geo.smem_bytes <= 232448  # one block's shared memory on sm_90
    # one 512K-row segment: one or two blocks per SM of an H100
    assert cg.geometry(524288, 84, 2, 0).n_chunks == 256
    assert cg.geometry(524288, 4096, 4, 2).n_chunks == 128
    # the main path's shapes in their regimes
    assert [cg.geometry(524288, G, Ms, 0).regime for G, Ms in
            [(1, 2), (26, 2), (12, 8), (84, 2), (208, 2)]] == [
        "lane", "lane", "lane", "warp", "warp"]
    assert cg.geometry(524288, 4096, 4, 2).regime == "block"


@pytest.mark.parametrize("R,G,Ms,Mnx", GEOMETRY_SHAPES)
def test_geometry_is_fixed_by_shapes(R, G, Ms, Mnx):
    geo = cg.geometry(R, G, Ms, Mnx)
    assert cg.geometry(R, G, Ms, Mnx) == geo  # same shapes, same order of adds
    # the scratch holds one [M, G] partial per chunk
    assert geo.scratch_floats == geo.n_chunks * (Ms + Mnx) * G
    # the accumulators and the ring of staged tiles fit the shared memory
    T = geo.tile_rows
    tile = 4 * T + T + 4 * T * Ms + 5 * T * Mnx
    copies = {"lane": 256, "warp": 8, "block": 1}[geo.regime]
    acc = copies * G * geo.cols * 4
    buckets = 3 * T + 32 if geo.regime == "block" else 0  # rows by owner warp
    tags = 0 if geo.regime == "lane" else 8 * 128 * 4  # election slots
    assert acc + buckets + tags + 2 * tile <= geo.smem_bytes <= 232448
    slots = G * geo.cols
    want = "lane" if 256 * slots * 4 <= 96 << 10 else (
        "warp" if 8 * slots * 4 <= 64 << 10 else "block")
    assert geo.regime == want


def test_geometry_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        cg.geometry(524288, 4096, 400, 0)


@pytest.mark.parametrize("runs", [1, 2, 40])
def test_plain_matches_reference_on_skewed_gids(runs):
    # a time-sorted segment: gid in a few sorted runs, the kernel's one-group path
    R, G, Ms, Mn, Mx = 8192, 84, 2, 1, 1
    gid, mask, sv, mmv, mmm = _mk(R, G, Ms, Mn, Mx, seed=7)
    gid = (np.arange(R) * runs // R + 3).astype(np.int32)
    arrs = [gid, mask, sv, mmv, mmm]
    want = jgb.dense_partial_aggregate(
        *_jax(arrs), num_groups=G, block_rows=1024, num_min=Mn, num_max=Mx
    )
    _check(cg.plain_partial_aggregate(*_torch(arrs), G, Mn, Mx), want)


def test_wrapper_rejects_other_devices():
    arrs = [t.to("meta") for t in _torch(_mk(1024, 4, 1, 0, 0))]
    with pytest.raises(ValueError, match="no kernel for device"):
        cg.cuda_partial_aggregate(*arrs, num_groups=4, num_min=0, num_max=0)
