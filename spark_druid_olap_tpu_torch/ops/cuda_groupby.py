"""Hand-written CUDA group-by kernel: fused partial aggregation on Hopper.

The counterpart of the reference package's `ops/pallas_groupby.py` (the
one-hot group-by kernel): same contract, same argument order, same output
layout.  The kernel is `csrc/groupby_partial.cu`; its header comment states
its bound and design.  It is compiled with `nvcc` for `sm_90a` into a shared
library with a plain C interface (under `build/torch_ext/` at the repository
root, at first use) and bound with ctypes: a few seconds of `nvcc`, where a
`torch.utils.cpp_extension` build that includes PyTorch's headers takes
minutes on every fresh machine.  The C entry point returns the CUDA error of
each launch (`cudaGetLastError`), which the wrapper raises on.  A failed
build and a refused launch raise `resilience.KernelError`, which the retry
policy classifies static: a broken kernel is never retried or answered on
the host.

`geometry` picks each launch's chunks, staged tiles, column blocks and
accumulator regime from the shapes alone, so the same shapes always sum in
the same order.  `cuda_partial_aggregate` launches the kernel for CUDA
tensors and counts each launch in `LAUNCHES`, and by (G, Ms, Mn, Mx) in
`LAUNCH_SHAPES` (the most rows a launch took at each in `LAUNCH_ROWS`);
for CPU tensors it runs `plain_partial_aggregate`, the
plain PyTorch version the tests and `chip_smoke.py` compare the kernel
with.  There is no fallback: a CUDA tensor the kernel does not take raises.

Launches inside a CUDA graph: while a graph is being captured, a call
records the kernel into the graph and launches nothing, so it is not
counted; its shape goes to the list that `capture_launches` collects, which
the graph keeps and hands to `count_replay` at every replay, where the
captured launches really run.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..resilience import KernelError, fire
from .groupby import SCATTER_CUTOVER, dense_partial_aggregate

# launches of the kernel since import (or since a caller reset it), in all
# and by (G, Ms, Mn, Mx); graph replays add the launches they captured
LAUNCHES = 0
LAUNCH_SHAPES: Dict[Tuple[int, int, int, int], int] = {}
# the most rows one launch (or one captured launch) took at each
# (G, Ms, Mn, Mx): with the shapes, it bounds the chunk counts a run met
LAUNCH_ROWS: Dict[Tuple[int, int, int, int], int] = {}

# shapes recorded into the CUDA graph being captured (`capture_launches`)
_captured: Optional[List[Tuple[int, int, int, int]]] = None

# nvcc's output from the build of this process, for the record
BUILD_LOG = ""

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "groupby_partial.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
_ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]

# geometry of a launch (see `geometry`); the kernel source checks the same
# limits and refuses a launch outside them
_THREADS = 256  # threads per block
_WARPS = 8
_MAX_COLS = 8  # aggregate columns one block accumulates
_RING = 2  # staged row tiles per block
_SMEM_MAX = 232448  # shared memory one block may have on sm_90
_SMEM_TWO_BLOCKS = 115 << 10  # at most this, two blocks share an SM
_LANE_ACC_MAX = 96 << 10  # a copy of the accumulators per thread up to this
_WARP_ACC_MAX = 64 << 10  # a copy per warp up to this
_TILE_ROWS = (1024, 512, 256)  # largest that fits is taken
_TAG_SLOTS = 128  # election slots per warp
# the accumulators' home, as the kernel numbers it (enum Regime)
_REGIMES = {"block": 0, "warp": 1, "lane": 2}
_COPIES = {"block": 1, "warp": _WARPS, "lane": _THREADS}

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelError("nvcc not found: the CUDA toolkit is needed to build the kernel")


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
    fire("compile")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    cmd = [
        _nvcc(), *_ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
        "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(_SRC),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.sdol_groupby_partial.argtypes = [p] * 9 + [i] * 9 + [p]
            lib.sdol_groupby_partial.restype = i
            lib.sdol_error_string.argtypes = [i]
            lib.sdol_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _round16(n: int) -> int:
    return -(-n // 16) * 16


class Geometry(NamedTuple):
    chunk_rows: int  # rows each partial_pass block folds
    tile_rows: int  # rows of one staged tile
    cols: int  # aggregate columns per block (grid y)
    regime: str  # accumulators per thread ("lane"), per warp, or per block
    n_chunks: int
    smem_bytes: int  # shared memory of one partial_pass block
    scratch_floats: int  # chunk partials, [n_chunks, M, G]


def _regime(G: int, cols: int) -> str:
    if _THREADS * G * cols * 4 <= _LANE_ACC_MAX:
        return "lane"
    return "warp" if _WARPS * G * cols * 4 <= _WARP_ACC_MAX else "block"


@functools.lru_cache(maxsize=1024)
def geometry(R: int, G: int, Ms: int, Mnx: int) -> Geometry:
    """The launch geometry, from the shapes alone: the same (R, G, M) always
    gives the same chunks and so the same order of adds.  Takes the most
    columns per block, then the largest staged tile, whose shared memory
    fits; 2048-row chunks (256 per 512K-row segment) where two blocks share
    an SM, else 4096."""
    M = Ms + Mnx
    for cols in sorted({min(max(M, 1), _MAX_COLS), 4, 2, 1}, reverse=True):
        if cols > max(M, 1):
            continue
        regime = _regime(G, cols)
        acc = _round16(_COPIES[regime] * G * cols * 4)
        for T in _TILE_ROWS:
            tile = 4 * T + _round16(T) + 4 * T * Ms + 4 * T * Mnx + _round16(T * Mnx)
            # the block regime buckets a tile's rows by owner warp; the
            # warp and block regimes elect writers in a table per warp
            buckets = _round16(3 * T + 4 * _WARPS) if regime == "block" else 0
            tags = 0 if regime == "lane" else _WARPS * _TAG_SLOTS * 4
            smem = acc + buckets + tags + _RING * tile
            if smem <= _SMEM_MAX:
                chunk = 2048 if smem <= _SMEM_TWO_BLOCKS else 4096
                n_chunks = -(-R // chunk)
                return Geometry(chunk, T, cols, regime, n_chunks, smem,
                                n_chunks * M * G)
    raise ValueError(
        f"{M} aggregate columns at {G} groups do not fit the kernel's shared memory"
    )


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


def _count(shape: Tuple[int, int, int, int]) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCH_SHAPES[shape] = LAUNCH_SHAPES.get(shape, 0) + 1


@contextlib.contextmanager
def capture_launches():
    """Collects the (G, Ms, Mn, Mx) of every launch recorded into a CUDA
    graph captured inside the block; the list it yields is what
    `count_replay` counts at each replay of that graph."""
    global _captured
    prev, _captured = _captured, []
    try:
        yield _captured
    finally:
        _captured = prev


def count_replay(shapes) -> None:
    """Counts the launches of one replay of a captured graph."""
    for shape in shapes:
        _count(shape)


def launch_record() -> dict:
    """This process's launches as JSON: the total, and per (G, Ms, Mn, Mx)
    the count and the most rows one launch took.  A process started by
    another (a historical, a rank) reports it, and its parent checks each
    shape and row count against the ones it verified."""
    shapes = sorted(set(LAUNCH_SHAPES) | set(LAUNCH_ROWS))
    return {"launches": LAUNCHES,
            "shapes": [[*shape, LAUNCH_SHAPES.get(shape, 0), LAUNCH_ROWS.get(shape, 0)]
                       for shape in shapes]}


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
    geo = geometry(R, num_groups, Ms, Mnx)
    sums = torch.empty((num_groups, Ms), dtype=torch.float32, device=dev)
    mins = torch.empty((num_groups, num_min), dtype=torch.float32, device=dev)
    maxs = torch.empty((num_groups, num_max), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (max(geo.scratch_floats, 1),), dtype=torch.float32, device=dev
    )
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.sdol_groupby_partial(
            gid.data_ptr(), mask.data_ptr(), sum_values.data_ptr(),
            minmax_values.data_ptr(), minmax_masks.data_ptr(),
            sums.data_ptr(), mins.data_ptr(), maxs.data_ptr(),
            scratch.data_ptr(), R, num_groups, Ms, num_min, num_max,
            geo.chunk_rows, geo.tile_rows, geo.cols, _REGIMES[geo.regime],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise KernelError(
            f"group-by kernel launch failed: {lib.sdol_error_string(rc).decode()}"
        )
    shape = (num_groups, Ms, num_min, num_max)
    LAUNCH_ROWS[shape] = max(LAUNCH_ROWS.get(shape, 0), R)
    if torch.cuda.is_current_stream_capturing():
        if _captured is None:
            raise KernelError(
                "the kernel was captured into a CUDA graph outside "
                "capture_launches(): its replays would go uncounted"
            )
        _captured.append(shape)
    else:
        _count(shape)
    return sums, mins, maxs
