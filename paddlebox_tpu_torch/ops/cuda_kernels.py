"""Hand-written CUDA kernels for the sparse pull/push hot path.

The counterpart of the JAX package's ``ops/pallas_kernels.py``. Each kernel
lives in ``ops/csrc/*.cu`` with a plain C launcher, is compiled with
``nvcc`` for ``sm_90a`` on first use into ``paddlebox_tpu_torch/_build/``,
and is loaded with ``ctypes`` (no PyTorch headers, so the build takes
seconds). Beside each kernel sits its plain PyTorch version, which the CPU
path and the tests use.

Kernels:

- :func:`pull_rows_cuda` — row gather ``table[rows]``; replaces
  ``pull_rows_pallas``. Plain version :func:`pull_rows_ref`.
- :func:`write_rows_cuda` — in-place row set ``table[rows] = new_rows``;
  replaces ``write_rows_pallas``. Plain version :func:`write_rows_ref`.

Both kernels are tiled the same way (``ops/csrc/row_tile.cuh``: a block
per tile of rows, the tile's row ids staged in shared memory once, the
tile moved with ``cp.async``); :func:`tile_geometry` computes their launch
geometry.

Every wrapper adds one to :data:`launch_counts` where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernel. A failed build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, NamedTuple, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-Xptxas=-v",  # registers, shared memory and spills of each kernel
)

# kernel name -> launches since the last reset_launch_counts()
launch_counts: Dict[str, int] = {"pull_rows_cuda": 0, "write_rows_cuda": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built"
        )
    return found


def _build(source: str) -> Tuple[str, str]:
    """Compile ``ops/csrc/<source>`` to a shared library; return its path
    and what ptxas reported on each kernel ("" when the library was built
    before).

    The library's name carries a hash of the source, the headers beside it
    and the flags, so an edited source never loads a stale build. It is
    compiled to a temporary path and renamed into place, so a concurrent
    loader sees the old file or the new one, never half of one."""
    src = os.path.join(_CSRC, source)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [source] + sorted(n for n in os.listdir(_CSRC) if n.endswith(".cuh")):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    lib = os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True,
            text=True,
            timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (rc {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    report = "\n".join(
        l.strip() for l in proc.stderr.splitlines() if l.startswith("ptxas info") or "spill" in l
    )
    return lib, report


# the launch geometry of both kernels, the last arguments before the stream
_GEOMETRY_ARGTYPES = [
    ctypes.c_int,  # tile_rows
    ctypes.c_int,  # tile_cols
    ctypes.c_longlong,  # grid_rows
    ctypes.c_int,  # grid_cols
    ctypes.c_int,  # threads
    ctypes.c_int,  # smem_bytes
    ctypes.c_void_p,  # cudaStream_t
]

# source -> (exported launcher, its ctypes argtypes); every source builds
# into its own library
_LAUNCHERS = {
    "gather_rows.cu": (
        "pbx_gather_rows_f32",
        [
            ctypes.c_void_p,  # table
            ctypes.c_longlong,  # R
            ctypes.c_int,  # W
            ctypes.c_void_p,  # rows
            ctypes.c_int,  # rows are int64
            ctypes.c_longlong,  # U
            ctypes.c_void_p,  # out
            *_GEOMETRY_ARGTYPES,
        ],
    ),
    "write_rows.cu": (
        "pbx_write_rows_f32",
        [
            ctypes.c_void_p,  # table (written in place)
            ctypes.c_longlong,  # R
            ctypes.c_int,  # W
            ctypes.c_void_p,  # rows
            ctypes.c_int,  # rows are int64
            ctypes.c_longlong,  # U
            ctypes.c_void_p,  # new_rows
            *_GEOMETRY_ARGTYPES,
        ],
    ),
}


# A block's tile: at most TILE_FLOATS f32 (16 KB) of shared memory, plus the
# tile's row ids as int64. Several such blocks fit on an SM, and at the
# flagship width (W = 21: 192 rows a tile) U = 122,880 rows are one wave.
TILE_FLOATS = 4096
TILE_MAX_ROWS = 1024  # narrow rows: ids would outgrow the tile
THREADS = 256
MAX_SMEM_BYTES = 48 * 1024  # dynamic shared memory without an opt-in
MAX_GRID_Y = 65535


class TileGeometry(NamedTuple):
    tile_rows: int  # T, rows a block owns; a multiple of 4
    tile_cols: int  # columns a block owns: W, or a slab of a wider row
    grid_rows: int  # blocks along the rows, ceil(U / T)
    grid_cols: int  # blocks along the columns, ceil(W / tile_cols)
    threads: int  # threads a block, a multiple of 32
    smem_bytes: int  # T int64 row ids, then the T x tile_cols f32 tile


def tile_geometry(U: int, W: int) -> TileGeometry:
    """Launch geometry of both kernels for U rows of width W.

    T % 4 == 0 keeps every tile of ``out`` and of an aligned ``new_rows``
    16-byte aligned, so whole tiles move as float4. U = 0 gives no block."""
    if W < 1:
        raise ValueError(f"row width W={W}: the kernels need W >= 1")
    tile_rows = min(TILE_MAX_ROWS, max(4, TILE_FLOATS // W // 4 * 4))
    tile_cols = min(W, TILE_FLOATS // tile_rows)
    grid_cols = -(-W // tile_cols)
    if grid_cols > MAX_GRID_Y:
        raise ValueError(f"row width W={W} needs {grid_cols} > {MAX_GRID_Y} column blocks")
    return TileGeometry(
        tile_rows=tile_rows,
        tile_cols=tile_cols,
        grid_rows=-(-U // tile_rows),
        grid_cols=grid_cols,
        threads=THREADS,
        smem_bytes=8 * tile_rows + 4 * tile_rows * tile_cols,
    )


def load_library(source: str) -> ctypes.CDLL:
    """Build (once per process and source) and load a kernel library, with
    its launcher's argtypes declared."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(_build(source)[0])
            name, argtypes = _LAUNCHERS[source]
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[source] = lib
        return lib


def build_all() -> Dict[str, str]:
    """Build and load every kernel of the port (set-up, before timing);
    return each source's ptxas report ("" where it was built before).

    One nvcc per source, all started together; then each library loads."""
    with ThreadPoolExecutor(max_workers=len(_LAUNCHERS)) as ex:
        futures = {source: ex.submit(_build, source) for source in _LAUNCHERS}
        reports = {source: f.result()[1] for source, f in futures.items()}
    for source in _LAUNCHERS:
        load_library(source)
    return reports


# ---- row gather -------------------------------------------------------------


def pull_rows_ref(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version of the row gather: ``table[rows]`` -> [U, W]."""
    return table.index_select(0, rows.long())


def _check_table_rows(kernel: str, table: torch.Tensor, rows: torch.Tensor) -> None:
    """The checks both kernels share: a contiguous f32 [R, W] CUDA table and
    1-D int32/int64 row ids on its device."""
    if not table.is_cuda:
        raise ValueError(f"{kernel} needs a CUDA table, got {table.device}")
    if rows.device != table.device:
        raise ValueError(
            f"rows on {rows.device} but table on {table.device}: same device needed"
        )
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(
            f"table must be a contiguous 2-D float32 tensor, got {table.dtype} "
            f"shape {tuple(table.shape)} contiguous={table.is_contiguous()}"
        )
    if rows.dtype not in (torch.int32, torch.int64) or rows.dim() != 1:
        raise ValueError(
            f"rows must be a 1-D int32/int64 tensor, got {rows.dtype} "
            f"shape {tuple(rows.shape)}"
        )


def pull_rows_cuda(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Row gather ``table[rows]`` on the GPU -> [U, W] f32, bit for bit.

    ``table`` is a contiguous f32 [R, W] CUDA tensor, ``rows`` a 1-D int32
    or int64 tensor on the same device; duplicates are fine. Launches on the
    current stream of the table's device and does not synchronise."""
    _check_table_rows("pull_rows_cuda", table, rows)
    rows = rows.contiguous()
    R, W = table.shape
    U = rows.shape[0]
    out = torch.empty((U, W), dtype=torch.float32, device=table.device)
    if U * W == 0:
        return out
    fn = load_library("gather_rows.cu").pbx_gather_rows_f32
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        rc = fn(
            table.data_ptr(),
            R,
            W,
            rows.data_ptr(),
            int(rows.dtype == torch.int64),
            U,
            out.data_ptr(),
            *tile_geometry(U, W),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"pull_rows_cuda launch failed: cudaError {rc}")
    launch_counts["pull_rows_cuda"] += 1
    return out


# ---- row writeback ------------------------------------------------------------


def write_rows_ref(
    table: torch.Tensor, rows: torch.Tensor, new_rows: torch.Tensor
) -> torch.Tensor:
    """Plain version of the row writeback: ``table[rows] = new_rows`` in
    place, returns ``table``. Exact because repeated rows (the padding row)
    carry identical contents. Every id lies in [0, R): where a caller
    names rows outside it, as the mesh owner names its idle runs (the
    kernel writes nothing for them), :func:`drop_out_of_range` takes them
    out first."""
    return table.index_copy_(0, rows.long(), new_rows)


def drop_out_of_range(
    table: torch.Tensor, rows: torch.Tensor, new_rows: torch.Tensor
) -> tuple:
    """``(rows, new_rows)`` without the ids outside [0, R), the ones the
    writeback kernel skips: what :func:`write_rows_ref` then writes is
    the kernel's result. The kept count sets the shapes, so on a card
    this reads back to the host."""
    rows = rows.long()
    keep = (rows >= 0) & (rows < table.shape[0])
    return rows[keep], new_rows[keep]


def write_rows_cuda(
    table: torch.Tensor, rows: torch.Tensor, new_rows: torch.Tensor
) -> torch.Tensor:
    """Row writeback ``table[rows[i]] = new_rows[i]`` on the GPU, in place;
    returns ``table``.

    ``table`` is a contiguous f32 [R, W] CUDA tensor, ``rows`` a 1-D int32
    or int64 tensor and ``new_rows`` an f32 [U, W] tensor, both on the
    table's device. Rows must be unique except for repeats carrying
    identical contents (the padding row). A row id outside [0, R) writes
    nothing. Launches on the current stream and does not synchronise."""
    _check_table_rows("write_rows_cuda", table, rows)
    R, W = table.shape
    U = rows.shape[0]
    if new_rows.device != table.device or new_rows.dtype != torch.float32:
        raise ValueError(
            f"new_rows must be float32 on {table.device}, got {new_rows.dtype} "
            f"on {new_rows.device}"
        )
    if tuple(new_rows.shape) != (U, W):
        raise ValueError(
            f"new_rows has shape {tuple(new_rows.shape)}, want ({U}, {W})"
        )
    rows = rows.contiguous()
    new_rows = new_rows.contiguous()
    if U * W == 0:
        return table
    fn = load_library("write_rows.cu").pbx_write_rows_f32
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        rc = fn(
            table.data_ptr(),
            R,
            W,
            rows.data_ptr(),
            int(rows.dtype == torch.int64),
            U,
            new_rows.data_ptr(),
            *tile_geometry(U, W),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"write_rows_cuda launch failed: cudaError {rc}")
    launch_counts["write_rows_cuda"] += 1
    return table
