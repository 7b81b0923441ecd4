"""The hand-written CUDA kernel on the card.

Every test here needs a CUDA card (the kernel has no CPU mode), carries the
`cuda` marker and skips without one.  The file imports only the PyTorch
port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: mins and maxs exactly equal to the plain version; sums within
rtol 1e-5 (the kernel sums in another order over up to 512K rows); two
launches bit-equal; engine frames on the card against the CPU within the
parity bound rtol 2e-5.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_druid_olap_tpu_torch.exec.engine import Engine
from spark_druid_olap_tpu_torch.ops import cuda_groupby as cg
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


@pytest.mark.parametrize("R,G,Ms,Mn,Mx", SHAPES)
def test_kernel_matches_plain(card, R, G, Ms, Mn, Mx):
    arrs = _mk(R, G, Ms, Mn, Mx, card, seed=6)
    before = cg.LAUNCHES
    got = cg.cuda_partial_aggregate(*arrs, num_groups=G, num_min=Mn, num_max=Mx)
    again = cg.cuda_partial_aggregate(*arrs, num_groups=G, num_min=Mn, num_max=Mx)
    want = cg.plain_partial_aggregate(*arrs, G, Mn, Mx)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # bit-identical run to run
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-5)


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
