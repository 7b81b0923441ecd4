"""The port's calibration (`plan/calibrate.py`) and the loading of its file
(`SessionConfig.load_calibrated`), on the CPU.

* `calibrate` at tiny rows on the CPU writes every constant of the cost
  model, finite and positive, with the device's name, the timing used and
  `"partial": false`; a budget that has run out leaves the unmeasured
  constants None (the loader keeps the device's defaults for them) and
  marks the file partial.
* The slope guards are the reference's: the same per-row cost from the
  same two timings, the same fallback for an inverted slope, the same
  bandwidth clamp.
* `load_calibrated` applies a file measured on a device of the same name
  and records it in `calibration_meta`; a file of another device is
  ignored with a warning, as the reference's guard does.  On the CPU it
  reads no file unless given one: the CPU gets the port's built-in CPU
  profile (measured from the port's plain versions on a CPU; it routes the
  CPU's queries and is no speed result), and `calibrate` on the CPU writes
  no file unless given a path.  A context built without a config carries
  the loaded meta.
* The committed `calibration.torch_cuda.json` was written by the module on
  an H100, names the card and its power limit, and its constants are the
  class defaults.
* The port never reads or writes the reference's calibration files.
"""

import builtins
import dataclasses
import json
import logging
import os

import numpy as np
import pytest

from spark_druid_olap_tpu.plan import calibrate as jcal
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.config import (
    CALIBRATED_FLOATS,
    CALIBRATED_INTS,
    CUDA_CALIBRATION,
    SessionConfig,
)
from spark_druid_olap_tpu_torch.plan import calibrate as tcal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_FILES = ("calibration.json", "calibration.cpu.json", "calibration.tpu.json")
TINY = dict(rows=8192, launches=1, reps=1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """One tiny calibration on the CPU, and every path it opened."""
    path = tmp_path_factory.mktemp("cal") / "calibration.torch_cpu.json"
    opened, real_open = [], builtins.open

    def spy(file, *a, **kw):
        opened.append(str(file))
        return real_open(file, *a, **kw)

    builtins.open = spy
    try:
        out = tcal.calibrate(save_path=str(path), device="cpu", **TINY)
        cfg = SessionConfig.load_calibrated(path=str(path), device="cpu")
    finally:
        builtins.open = real_open
    return path, out, cfg, opened


@pytest.mark.parametrize("platform", ["cpu", "tpu", "torch_cuda"])
@pytest.mark.parametrize("root", [None, "elsewhere"])
def test_sidecar_path_is_the_references(tmp_path, platform, root):
    from spark_druid_olap_tpu_torch import config as tconfig

    where = None if root is None else str(tmp_path)
    assert tcal.sidecar_path(platform, where) == jcal.sidecar_path(platform, where)
    assert tcal.sidecar_path("torch_cuda") == tconfig.CUDA_CALIBRATION


def test_calibration_schema(tiny):
    path, out, _, _ = tiny
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    assert (out["device"], out["platform"], out["kernel_class"], out["dense_timing"]) == (
        "cpu", "cpu", "dense", "eager")
    assert out["partial"] is False and out["power_limit"] is None
    assert (out["rows"], out["rows_lo"], out["launches"]) == (8192, 2048, 1)
    assert (out["eager_rows"], out["eager_rows_lo"]) == (8192, 2048)  # on a card 16x
    assert (out["scatter_lo_groups"], out["scatter_hi_groups"]) == (1024, 1 << 20)
    for k in CALIBRATED_FLOATS + CALIBRATED_INTS:
        assert np.isfinite(out[k]) and out[k] > 0, k
    assert 1 <= out["dense_tile_groups"] <= 4096
    assert out["cost_per_row_compact"] >= out["cost_per_row_scatter"]
    assert out["cost_per_row_scatter_hi"] >= out["cost_per_row_scatter"]
    # each measured constant's spread: the least and most slope of any two
    # repeats, one at each size, unguarded (the dispatch's: its times)
    for k in CALIBRATED_FLOATS:
        if k != "h2d_bytes_per_s":
            lo, hi = out["spread"][k]
            assert np.isfinite(lo) and lo <= hi, k
    assert 0 < out["spread"]["cost_dispatch_us"][0]


def test_loaded_calibration_and_its_meta(tiny):
    path, out, cfg, _ = tiny
    for k in CALIBRATED_FLOATS + CALIBRATED_INTS:
        assert getattr(cfg, k) == out[k], k
    assert cfg.calibration_meta == {"path": str(path), "device": "cpu", "power_limit": None,
                                    "partial": False, "applied": True, "source": "file"}


def test_a_spent_budget_marks_the_file_partial(tmp_path):
    path = tmp_path / "calibration.json"
    out = tcal.calibrate(save_path=str(path), device="cpu", budget_s=0.0, **TINY)
    assert out["partial"] is True
    for k in ("cost_per_row_scatter_hi", "cost_per_group_state", "cost_per_row_sparse",
              "h2d_bytes_per_s", "cost_per_row_interp", "cost_per_group_decode"):
        assert out[k] is None, k
    # the compaction reads at least what a scatter pass reads
    assert out["cost_per_row_compact"] == out["cost_per_row_scatter"]
    cfg = SessionConfig.load_calibrated(path=str(path), device="cpu")
    profile = SessionConfig().apply_platform_profile("cpu")
    assert cfg.cost_per_row_scatter == out["cost_per_row_scatter"]
    assert cfg.cost_per_row_sparse == profile.cost_per_row_sparse  # kept: unmeasured
    assert cfg.calibration_meta["partial"] is True and cfg.calibration_meta["applied"]


@pytest.mark.parametrize("case", [
    (0.2, 0.1, 1000, 500, 0.05, 1e-6),  # a healthy slope
    (0.1, 0.11, 1000, 500, 0.06, 1e-6),  # inverted: the single point less the round trip
    (0.060001, 0.07, 1000, 500, 0.06, 5.0),  # the floor wins
    (0.5, 0.5, 4096, 1024, 0.0, 1e-6),  # flat
])
def test_slope_guard_is_the_references(case):
    assert tcal._slope_or_fallback(*case) == pytest.approx(jcal._slope_or_fallback(*case))


@pytest.mark.parametrize("bw", [1.0, 4.5e7, 4e10, 1e17])
def test_bandwidth_clamp_is_the_references(bw):
    assert tcal._clamp_bandwidth(bw) == jcal._clamp_bandwidth(bw)


def test_another_devices_file_is_ignored(tmp_path, caplog):
    p = tmp_path / "calibration.torch_cuda.json"
    p.write_text(json.dumps({"device": "NVIDIA A100-SXM4-80GB", "power_limit": "400.00 W",
                             "cost_per_row_dense": 123.0, "partial": False}))
    with caplog.at_level(logging.WARNING):
        cfg = SessionConfig.load_calibrated(path=str(p), device="cpu")
    assert "ignoring calibration file" in caplog.text and "NVIDIA A100" in caplog.text
    assert cfg.cost_per_row_dense != 123.0
    assert cfg.cost_per_row_dense == SessionConfig().apply_platform_profile("cpu").cost_per_row_dense
    assert cfg.calibration_meta == {
        "path": str(p), "device": "NVIDIA A100-SXM4-80GB", "power_limit": "400.00 W",
        "partial": False, "applied": False, "source": "cpu profile", "mismatch": True}


def test_the_cpu_profile_without_a_file(tmp_path, monkeypatch):
    """The CPU reads no file: the CPU profile (and a context built without
    a config carries it), whatever file lies in the working directory or
    at the repository root; `calibrate` on the CPU writes none unless given
    a path.  A card keeps the class defaults, its calibration."""
    monkeypatch.chdir(tmp_path)
    stray = {"device": "cpu", "cost_per_row_dense": 123.0, "partial": False}
    for name in ("calibration.torch_cpu.json", "calibration.torch_cuda.json"):
        (tmp_path / name).write_text(json.dumps(stray))
    cfg = SessionConfig.load_calibrated(device="cpu")
    assert cfg.calibration_meta == {"path": None, "device": "cpu", "power_limit": None,
                                    "partial": None, "applied": False, "source": "cpu profile"}
    assert dataclasses.replace(cfg, calibration_meta=None) == \
        SessionConfig().apply_platform_profile("cpu")
    assert SessionConfig().apply_platform_profile("cuda") == SessionConfig()
    ctx = TPUOlapContext(device="cpu")
    assert ctx.config.calibration_meta["device"] == "cpu"
    assert ctx.engine.cost_config is ctx.config
    before = sorted(os.listdir(tmp_path)), sorted(os.listdir(ROOT))
    tcal.calibrate(device="cpu", budget_s=0.0, **TINY)
    assert (sorted(os.listdir(tmp_path)), sorted(os.listdir(ROOT))) == before
    assert CUDA_CALIBRATION == os.path.join(ROOT, "calibration.torch_cuda.json")


def test_committed_card_calibration_is_the_class_defaults():
    with open(os.path.join(ROOT, "calibration.torch_cuda.json")) as f:
        data = json.load(f)
    assert data["device"].startswith("NVIDIA H100") and data["power_limit"].endswith("W")
    assert (data["platform"], data["kernel_class"], data["partial"]) == ("cuda", "cuda", False)
    assert data["dense_timing"] == "graph replay"
    defaults = SessionConfig()
    for k in CALIBRATED_FLOATS + CALIBRATED_INTS:
        assert data[k] > 0 and getattr(defaults, k) == data[k], k


def test_reference_calibration_files_are_never_touched(tiny):
    """The port reads and writes its own files only: the tiny run and its
    load opened no reference file, and those files are as committed."""
    path, _, _, opened = tiny
    assert [p for p in opened if os.path.basename(p) in REFERENCE_FILES] == []
    assert str(path) in opened
    for name in REFERENCE_FILES:
        assert not CUDA_CALIBRATION.endswith(name)


def test_the_collective_is_unmeasured_below_two_cards(tiny, tmp_path):
    """The mesh's merge rate needs two or more distinct cards: on one device
    the file marks it unmeasured (None, with the reason), and the config
    keeps its default, the data sheet's NVLink rate; a file that has it
    sets it."""
    path, out, cfg, _ = tiny
    assert out["collective_bytes_per_us"] is None
    assert out["collective"].startswith("unmeasured")
    assert cfg.collective_bytes_per_us == SessionConfig().collective_bytes_per_us == 450_000.0
    data = json.loads(path.read_text())
    data["collective_bytes_per_us"] = 123_456.0
    measured = tmp_path / "calibration.json"
    measured.write_text(json.dumps(data))
    got = SessionConfig.load_calibrated(path=str(measured), device="cpu")
    assert got.collective_bytes_per_us == 123_456.0
