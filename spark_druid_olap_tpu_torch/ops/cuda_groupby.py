"""Hand-written CUDA group-by kernel: fused partial aggregation on Hopper.

The counterpart of the reference package's `ops/pallas_groupby.py` (the
one-hot group-by kernel): same contract, same argument order, same output
layout.  The kernel is `csrc/groupby_partial.cu`; its header comment states
its bound and design.  It is compiled with `nvcc` for `sm_90a` into a shared
library with a plain C interface (under `build/torch_ext/` at the repository
root, at first use) and bound with ctypes: a few seconds of `nvcc`, where a
`torch.utils.cpp_extension` build that includes PyTorch's headers takes
minutes on every fresh machine.  The C entry point returns the CUDA error of
each launch (`cudaGetLastError`), which the wrapper raises on.

`cuda_partial_aggregate` launches the kernel for CUDA tensors and counts
each launch in `LAUNCHES`; for CPU tensors it runs
`plain_partial_aggregate`, the plain PyTorch version the tests and
`chip_smoke.py` compare the kernel with.  There is no fallback: a CUDA
tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import torch

from .groupby import SCATTER_CUTOVER, dense_partial_aggregate

# launches of the kernel since import (or since a caller reset it)
LAUNCHES = 0

# nvcc's output from the build of this process, for the record
BUILD_LOG = ""

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "groupby_partial.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
_ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]

# rows each pass-1 block folds: 1024 (one staged tile) unless that makes
# more than this many blocks, then doubled up to _MAX_CHUNK_ROWS
_TARGET_BLOCKS = 8 * 132
_MAX_CHUNK_ROWS = 8192
_STAGE_ROWS = 1024
_COLS_PER_BLOCK = 8

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernel")


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path.  The file name carries a hash of the source and the
    flags, so an edited source never loads a stale library."""
    global BUILD_LOG
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_ARCH_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"groupby_partial_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    cmd = [
        _nvcc(), *_ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
        "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(_SRC),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.sdol_groupby_partial.argtypes = [p] * 9 + [i] * 6 + [p]
            lib.sdol_groupby_partial.restype = i
            lib.sdol_error_string.argtypes = [i]
            lib.sdol_error_string.restype = ctypes.c_char_p
            lib.sdol_groupby_stage_rows.restype = i
            if lib.sdol_groupby_stage_rows() != _STAGE_ROWS:
                raise RuntimeError("kernel library and wrapper disagree on the staged tile")
            _lib = lib
        return _lib


def chunk_rows_for(R: int, G: int, M: int) -> int:
    """Rows per pass-1 block: enough blocks to fill the card, few enough
    chunks that the scratch and the fixed-order second pass stay small."""
    gt = 1
    while gt < G and gt < 256:
        gt <<= 1
    per_chunk = -(-G // gt) * -(-M // _COLS_PER_BLOCK)
    rows = _STAGE_ROWS
    while (
        rows < _MAX_CHUNK_ROWS
        and -(-R // rows) * per_chunk > _TARGET_BLOCKS
    ):
        rows *= 2
    return rows


def plain_partial_aggregate(
    gid, mask, sum_values, minmax_values, minmax_masks,
    num_groups: int, num_min: int, num_max: int,
):
    """The plain PyTorch version of the kernel: a one-hot per 1024-row
    block contracted with `torch.matmul` in float32, masked min/max.  On the
    card TF32 must be off for that product; it is asserted here rather than
    set, so a caller's global setting is never changed behind its back."""
    if gid.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the plain version "
            "needs full float32 products"
        )
    return dense_partial_aggregate(
        gid, mask, sum_values, minmax_values, minmax_masks,
        num_groups=num_groups, block_rows=1024,
        num_min=num_min, num_max=num_max,
    )


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cuda_partial_aggregate(
    gid: torch.Tensor,  # int32[R]
    mask: torch.Tensor,  # bool[R]
    sum_values: torch.Tensor,  # f32[R, Ms] pre-masked
    minmax_values: torch.Tensor,  # f32[R, Mn+Mx] raw
    minmax_masks: torch.Tensor,  # bool[R, Mn+Mx]
    num_groups: int,
    num_min: int,
    num_max: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (sums[G, Ms], mins[G, Mn], maxs[G, Mx]); empty groups are
    0 / +inf / -inf.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    global LAUNCHES
    if gid.device.type == "cpu":
        return plain_partial_aggregate(
            gid, mask, sum_values, minmax_values, minmax_masks,
            num_groups, num_min, num_max,
        )
    if gid.device.type != "cuda":
        raise ValueError(f"no kernel for device {gid.device}")
    R = gid.shape[0]
    Ms = sum_values.shape[1] if sum_values.dim() == 2 else -1
    Mnx = num_min + num_max
    if not 1 <= num_groups <= SCATTER_CUTOVER:
        raise ValueError(
            f"num_groups {num_groups} outside the kernel's range "
            f"[1, {SCATTER_CUTOVER}]"
        )
    _check("gid", gid, torch.int32, (R,))
    _check("mask", mask, torch.bool, (R,))
    _check("sum_values", sum_values, torch.float32, (R, Ms))
    _check("minmax_values", minmax_values, torch.float32, (R, Mnx))
    _check("minmax_masks", minmax_masks, torch.bool, (R, Mnx))
    for name, t in (("mask", mask), ("sum_values", sum_values),
                    ("minmax_values", minmax_values),
                    ("minmax_masks", minmax_masks)):
        if t.device != gid.device:
            raise ValueError(f"{name} is on {t.device}, gid on {gid.device}")
    dev = gid.device
    M = Ms + Mnx
    rows = chunk_rows_for(R, num_groups, M)
    n_chunks = -(-R // rows)
    sums = torch.empty((num_groups, Ms), dtype=torch.float32, device=dev)
    mins = torch.empty((num_groups, num_min), dtype=torch.float32, device=dev)
    maxs = torch.empty((num_groups, num_max), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (max(n_chunks * M * num_groups, 1),), dtype=torch.float32, device=dev
    )
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.sdol_groupby_partial(
            gid.data_ptr(), mask.data_ptr(), sum_values.data_ptr(),
            minmax_values.data_ptr(), minmax_masks.data_ptr(),
            sums.data_ptr(), mins.data_ptr(), maxs.data_ptr(),
            scratch.data_ptr(), R, num_groups, Ms, num_min, num_max, rows,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"group-by kernel launch failed: {lib.sdol_error_string(rc).decode()}"
        )
    LAUNCHES += 1
    return sums, mins, maxs
