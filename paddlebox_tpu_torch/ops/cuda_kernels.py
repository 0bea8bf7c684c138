"""Hand-written CUDA kernels for the sparse pull/push hot path.

The counterpart of the JAX package's ``ops/pallas_kernels.py``. Each kernel
lives in ``ops/csrc/*.cu`` with a plain C launcher, is compiled with
``nvcc`` for ``sm_90a`` on first use into ``paddlebox_tpu_torch/_build/``
(or into the compile cache, ``utils/compilecache.py``, when one is
enabled), and is loaded with ``ctypes`` (no PyTorch headers, so the build
takes seconds). Beside each kernel sits its plain PyTorch version, which
the CPU path and the tests use.

Kernels:

- :func:`pull_rows_cuda` — row gather ``table[rows]``; replaces
  ``pull_rows_pallas``. Plain version :func:`pull_rows_ref`.
- :func:`write_rows_cuda` — in-place row set ``table[rows] = new_rows``;
  replaces ``write_rows_pallas``. Plain version :func:`write_rows_ref`.
- :func:`merge_rows_cuda` — the push merge: each unique row's sums of its
  keys' scaled gradients, show and clk, in merge order, straight from the
  per-key gradients; replaces no TPU kernel (the JAX package leaves the
  merge to XLA), the analog of the original's ``PushMergeCopy``. Plain
  version :func:`merge_rows_ref`; :func:`merge_order` gives the order.

The gather and the writeback are tiled the same way (``ops/csrc/row_tile.cuh``: a block
per tile of rows, the tile's row ids staged in shared memory once, the
tile moved with ``cp.async``); :func:`tile_geometry` computes their launch
geometry.

Every wrapper adds one to :data:`launch_counts` where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernel. A failed build or launch raises; nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from paddlebox_tpu_torch.utils import compilecache
from paddlebox_tpu_torch.utils.monitor import STAT_ADD

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
launch_counts: Dict[str, int] = {"pull_rows_cuda": 0, "write_rows_cuda": 0, "merge_rows_cuda": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock
_toolkit_lock = threading.Lock()
_toolkit_ids: Dict[str, str] = {}  # guarded-by: _toolkit_lock
_runs_lock = threading.Lock()
_nvcc_runs: List[Tuple[str, float]] = []  # guarded-by: _runs_lock


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be keyed, so none is built or loaded"
        )
    return found


def _toolkit_id(nvcc: str) -> str:
    """``nvcc --version`` of this toolkit, read once a process."""
    with _toolkit_lock:
        out = _toolkit_ids.get(nvcc)
        if out is None:
            proc = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
            if proc.returncode != 0:
                raise RuntimeError(f"{nvcc} --version failed (rc {proc.returncode}): {proc.stderr}")
            out = _toolkit_ids[nvcc] = proc.stdout
        return out


def library_name(source: str) -> str:
    """``lib<stem>-<key>.so``: the key hashes the source, the headers
    beside it, the flags and the toolkit's ``nvcc --version``, so an edited
    file or another toolkit never loads a stale build. The key is the same
    in ``_build/`` and in the compile cache, so a miss can fill the cache
    from ``_build/``; loading a built library therefore needs ``nvcc`` too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_toolkit_id(_nvcc()).encode())
    for name in [source] + sorted(n for n in os.listdir(_CSRC) if n.endswith(".cuh")):
        h.update(pathlib.Path(_CSRC, name).read_bytes())
    return f"lib{os.path.splitext(source)[0]}-{h.hexdigest()[:16]}.so"


def nvcc_runs() -> List[Tuple[str, float]]:
    """(source, seconds) of every nvcc build this process ran."""
    with _runs_lock:
        return list(_nvcc_runs)


@contextlib.contextmanager
def _locked(path: str):
    """An exclusive ``flock`` on ``path + ".lock"``, across processes and
    threads alike (each holder opens its own descriptor)."""
    fd = os.open(path + ".lock", os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def _nvcc_build(source: str, lib: str) -> str:
    """Compile ``ops/csrc/<source>`` to ``lib``; return what ptxas reported
    on each kernel. It is compiled to a temporary path and renamed into
    place, so a concurrent loader sees no file or the whole one."""
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, source)],
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
    with _runs_lock:
        _nvcc_runs.append((source, time.perf_counter() - t0))
    return "\n".join(
        l.strip() for l in proc.stderr.splitlines() if l.startswith("ptxas info") or "spill" in l
    )


def _build(source: str) -> Tuple[str, str]:
    """The shared library of ``ops/csrc/<source>``: its path, and what
    ptxas reported on each kernel ("" when nvcc did not run).

    Without a compile cache (``utils/compilecache.py``) the library lives
    in ``_build/``. With one, each call is a request: a hit loads the
    keyed library from the cache; a miss copies it from ``_build/`` when it
    is there, else runs nvcc into the cache, and ``_build/`` is left as it
    was. A build holds a file lock on its library's path, so ranks sharing
    a directory run one nvcc, not several."""
    name = library_name(source)
    cache = compilecache.enabled_dir()
    if cache is None:
        lib = os.path.join(BUILD_DIR, name)
        if os.path.exists(lib):
            return lib, ""
        os.makedirs(BUILD_DIR, exist_ok=True)
        with _locked(lib):
            return lib, "" if os.path.exists(lib) else _nvcc_build(source, lib)
    STAT_ADD("compile_cache.requests")
    lib = os.path.join(cache, name)
    if os.path.exists(lib):
        STAT_ADD("compile_cache.hits")
        return lib, ""
    STAT_ADD("compile_cache.misses")
    os.makedirs(cache, exist_ok=True)
    with _locked(lib):
        if os.path.exists(lib):  # another rank filled it meanwhile
            return lib, ""
        local = os.path.join(BUILD_DIR, name)
        if not os.path.exists(local):
            return lib, _nvcc_build(source, lib)
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            shutil.copyfile(local, tmp)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib, ""


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
    "merge_rows.cu": (
        "pbx_merge_rows_f32",
        [
            ctypes.c_void_p,  # gflat
            ctypes.c_void_p,  # order (int64)
            ctypes.c_void_p,  # offsets (int32)
            ctypes.c_void_p,  # segments (int32)
            ctypes.c_void_p,  # labels
            ctypes.c_void_p,  # ins_weight or NULL
            ctypes.c_void_p,  # slot_lr or NULL
            ctypes.c_float,  # grad_div
            ctypes.c_int,  # has_div
            ctypes.c_longlong,  # U
            ctypes.c_int,  # W
            ctypes.c_int,  # S
            ctypes.c_int,  # b
            ctypes.c_void_p,  # out [U, W + 2]
            ctypes.c_void_p,  # heavy (scratch, int64 [U * min_slabs + L / slab_keys + 1])
            ctypes.c_void_p,  # counters (scratch, int32 [2])
            ctypes.c_int,  # group
            ctypes.c_int,  # cols
            ctypes.c_int,  # slabs
            ctypes.c_int,  # heavy_min
            ctypes.c_int,  # slab_keys
            ctypes.c_int,  # min_slabs
            ctypes.c_int,  # max_slabs
            ctypes.c_int,  # stage_floats
            ctypes.c_int,  # heavy_grid
            ctypes.c_void_p,  # cudaStream_t
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


# ---- push merge ---------------------------------------------------------------

MERGE_BLOCK_COLS = 256  # a heavy item's columns at most: one a thread of the block
MERGE_MAX_SLABS = 31  # heavy items a row at most
MERGE_MAX_WIDTH = MERGE_BLOCK_COLS * MERGE_MAX_SLABS
MERGE_HEAVY_MIN = 32  # a row of more keys gets a whole block (the heavy pass)
MERGE_STAGE_FLOATS = 3840  # a heavy chunk's rows: 15 KB of floats, so 3 blocks fit an SM
MERGE_SLAB_KEYS = 2048  # a heavy row takes a column slab (a block) for each this many keys...
MERGE_MIN_SLAB_COLS = 16  # ...of at least this many columns


class MergeGeometry(NamedTuple):
    group: int  # G, lanes a group: a power of two up to 32
    cols: int  # NC, columns a lane in the light pass: ceil(W / G), at most 8
    slabs: int  # column slabs of G * NC along grid y
    heavy_min: int  # rows of more keys go to the heavy pass
    slab_keys: int  # a heavy row is split into a column slab for each slab_keys keys,
    min_slabs: int  # at least min_slabs (of MERGE_BLOCK_COLS columns at most)
    max_slabs: int  # and at most max_slabs
    stage_floats: int  # floats of a heavy chunk's rows: 128 keys at most, fewer as wide


def merge_geometry(W: int) -> MergeGeometry:
    """Launch geometry of the merge for rows of W columns: G the smallest
    power of two that covers W, capped at a warp (16 at W = 13, 32 at 35
    and 131)."""
    if not 1 <= W <= MERGE_MAX_WIDTH:
        raise ValueError(f"merge_rows_cuda takes rows of 1 to {MERGE_MAX_WIDTH} columns, got {W}")
    group = min(32, 1 << (W - 1).bit_length())
    cols = min(8, -(-W // group))
    min_slabs = -(-W // MERGE_BLOCK_COLS)
    return MergeGeometry(
        group=group,
        cols=cols,
        slabs=-(-W // (group * cols)),
        heavy_min=MERGE_HEAVY_MIN,
        slab_keys=MERGE_SLAB_KEYS,
        min_slabs=min_slabs,
        max_slabs=max(min_slabs, min(MERGE_MAX_SLABS, W // MERGE_MIN_SLAB_COLS)),
        stage_floats=MERGE_STAGE_FLOATS,
    )


def merge_order(inverse: torch.Tensor, num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order int64 [L], offsets int32 [num_segments + 1]) of ``inverse``,
    whose ids lie in [0, num_segments): the keys in stable order of their
    id, and where each id's run starts in that order (``offsets[-1]`` is
    L)."""
    order = torch.argsort(inverse, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=inverse.dtype, device=inverse.device)
    return order, torch.searchsorted(inverse[order], bounds, out_int32=True)


def merge_rows_ref(
    gflat: torch.Tensor,
    order: torch.Tensor,
    offsets: torch.Tensor,
    segments: torch.Tensor,
    labels: torch.Tensor,
    num_slots: int,
    batch_size: int,
    ins_weight: Optional[torch.Tensor] = None,
    slot_lr: Optional[torch.Tensor] = None,
    grad_div: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the push merge: (guniq [U, W], show [U], clk [U]).

    Scales each key's gradient row (``/ grad_div`` by a tensor divisor: a
    scalar one may multiply by its reciprocal; ``* slot_lr[slot]``;
    ``* pad_mask``), appends its ``valid`` (the pad mask times its
    instance's weight) and ``label * valid``, gathers the [L, W + 2] rows
    into ``order`` and sums each run of ``offsets`` with a lengths-based
    ``segment_reduce``, in key order."""
    S, b = num_slots, batch_size
    if grad_div != 1.0:
        gflat = torch.div(gflat, torch.full((), grad_div, dtype=gflat.dtype, device=gflat.device))
    if slot_lr is not None:
        slot_of_key = torch.clamp(segments // b, max=S - 1).long()
        gflat = gflat * slot_lr[slot_of_key][:, None]
    pad_mask = (segments < S * b).to(torch.float32)  # [L] 0 on pad keys
    ins_of_key = (segments % b).long()
    valid = pad_mask if ins_weight is None else pad_mask * ins_weight[ins_of_key]
    gflat = gflat * pad_mask[:, None]
    ext = torch.cat([gflat, valid[:, None], (labels[ins_of_key] * valid)[:, None]], dim=1)
    lengths = (offsets[1:] - offsets[:-1]).long()
    # the lengths sum to L by construction: unsafe=True skips the check
    summed = torch.segment_reduce(ext[order], "sum", lengths=lengths, axis=0, unsafe=True)
    return summed[:, :-2], summed[:, -2], summed[:, -1]


def merge_rows_cuda(
    gflat: torch.Tensor,
    order: torch.Tensor,
    offsets: torch.Tensor,
    segments: torch.Tensor,
    labels: torch.Tensor,
    num_slots: int,
    batch_size: int,
    ins_weight: Optional[torch.Tensor] = None,
    slot_lr: Optional[torch.Tensor] = None,
    grad_div: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The push merge on the GPU: :func:`merge_rows_ref`'s result, bit for
    bit and in its layout (views of one [U, W + 2] array), with no [L, ...]
    array built.

    ``gflat`` is an f32 [L, W] CUDA tensor (1 <= W <= MERGE_MAX_WIDTH), ``order`` an
    int64 [L] permutation, ``offsets`` int32 [U + 1], ``segments`` [L]
    (cast to int32), ``labels``, ``ins_weight`` f32 [b] and ``slot_lr`` f32
    [num_slots], all on its device. Launches on the current stream and
    does not synchronise."""
    if not gflat.is_cuda:
        raise ValueError(f"merge_rows_cuda needs CUDA tensors, got gflat on {gflat.device}")
    if gflat.dtype != torch.float32 or gflat.dim() != 2:
        raise ValueError(f"gflat must be a 2-D float32 tensor, got {gflat.dtype} shape {tuple(gflat.shape)}")
    L, W = gflat.shape
    b = batch_size
    geo = merge_geometry(W)
    dev = gflat.device
    opt = {"ins_weight": ins_weight, "slot_lr": slot_lr}
    for name, t, dtype, n in (
        ("order", order, torch.int64, L),
        ("segments", segments, segments.dtype, L),
        ("labels", labels, torch.float32, b),
        *((k, v, torch.float32, b if k == "ins_weight" else num_slots) for k, v in opt.items() if v is not None),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != (n,):
            raise ValueError(
                f"{name} must be {dtype} [{n}] on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if offsets.device != dev or offsets.dtype != torch.int32 or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"offsets must be int32 [U + 1] on {dev}, got {offsets.dtype} {tuple(offsets.shape)}")
    U = offsets.shape[0] - 1
    # laid out as merge_rows_ref's reduction, so what reads the views reads
    # the same strides (a row reduction over them keeps its order)
    out = torch.empty((U, W + 2), dtype=torch.float32, device=dev)
    if U == 0:
        return out[:, :-2], out[:, -2], out[:, -1]
    gflat, order, offsets, labels = (t.contiguous() for t in (gflat, order, offsets, labels))
    segments = segments.to(torch.int32).contiguous()
    ins_weight, slot_lr = (None if t is None else t.contiguous() for t in (ins_weight, slot_lr))
    heavy = torch.empty((U * geo.min_slabs + L // geo.slab_keys + 1,), dtype=torch.int64, device=dev)
    counters = torch.empty((2,), dtype=torch.int32, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = load_library("merge_rows.cu").pbx_merge_rows_f32
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(
            gflat.data_ptr(),
            order.data_ptr(),
            offsets.data_ptr(),
            segments.data_ptr(),
            labels.data_ptr(),
            None if ins_weight is None else ins_weight.data_ptr(),
            None if slot_lr is None else slot_lr.data_ptr(),
            float(grad_div),
            int(grad_div != 1.0),
            U,
            W,
            num_slots,
            b,
            out.data_ptr(),
            heavy.data_ptr(),
            counters.data_ptr(),
            geo.group,
            geo.cols,
            geo.slabs,
            geo.heavy_min,
            geo.slab_keys,
            geo.min_slabs,
            geo.max_slabs,
            geo.stage_floats,
            3 * n_sm,  # heavy blocks: 73 KB of shared memory each
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"merge_rows_cuda launch failed: cudaError {rc}")
    launch_counts["merge_rows_cuda"] += 1
    return out[:, :-2], out[:, -2], out[:, -1]
