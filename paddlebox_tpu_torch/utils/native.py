"""ctypes binding for the native C++ host tier (``csrc/*.cc``).

The port binds the same three sources the JAX package builds and never
edits them:

- ``csrc/slot_parser.cc``: a whole part file parsed in one call into
  columnar arrays (:func:`parse_buffer_columnar`);
- ``csrc/batch_packer.cc``: the per-batch ragged gather, first-occurrence
  dedup and segment ids (:class:`NativePacker`), the ragged float-slot
  gather (:func:`gather_f32_slot`) and the resident feed's pad sweep
  (:func:`block_stats`);
- ``csrc/host_table.cc``: the sharded key -> row host store
  (:class:`NativeHostStore`), its memory tier and its disk (spill) tier.

The library is built on first use with ``g++ -O3 -shared -fPIC -std=c++17``
into ``paddlebox_tpu_torch/_build/``. Its name carries a hash of the
sources and the flags, so an edited source never loads a stale build; it is
compiled to a pid-suffixed temporary file under a file lock and renamed
into place, so concurrent builds (test workers) neither tear it nor
build it twice. When the library cannot be built or loaded, :func:`load`
raises: nothing falls back to the Python tier behind the caller's back.
ctypes releases the GIL for every call, so packer threads overlap.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.data.slot_schema import SlotSchema

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
SOURCES = tuple(
    os.path.join(_REPO, "csrc", name)
    for name in ("slot_parser.cc", "batch_packer.cc", "host_table.cc")
)
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock

_u64p = ctypes.POINTER(ctypes.c_uint64)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)

# spill victim-selection policies (csrc/host_table.cc kSpill*)
SPILL_FIFO = 0  # creation-order sweep, untouched rows first
SPILL_FREQ = 1  # coldness-ranked: admission/pin thresholds, then (show, epoch)

# the int64 columns of pbx_table_tier_stats, one row per shard
TIER_STAT_FIELDS = (
    "mem_rows", "disk_rows", "spilled_total", "promoted_total",
    "admitted_disk_first", "lazy_shrunk", "dead_records", "spill_bytes",
)

# the cumulative int64 slots of pbx_table_io_stats: where the writeback and
# spill IO time went (the spill writers' gather vs fwrite split, and the
# push pre-pass header reads)
IO_STAT_FIELDS = (
    "spill_gather_ns", "spill_fwrite_ns", "prepass_read_ns",
    "stage_flushes", "stage_bytes",
)


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpbx_host-{h.hexdigest()[:16]}.so")


def build() -> Tuple[str, float]:
    """Build the library unless it is built; return its path and the
    seconds spent compiling (0.0 when an earlier build was found)."""
    lib = library_path()
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".libpbx_host.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(lib):  # another process built it meanwhile
            return lib, 0.0
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        try:
            try:
                proc = subprocess.run(
                    [CXX, *CXX_FLAGS, "-o", tmp, *SOURCES],
                    capture_output=True, text=True, timeout=600,
                )
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"native host tier: {CXX} could not run: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native host tier: {CXX} failed (rc {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib, time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> None:
    def fn(name, restype, argtypes):
        f = getattr(lib, name)
        f.restype = restype
        f.argtypes = argtypes

    # --- slot parser
    fn("pbx_parse_buffer", ctypes.c_void_p, [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ])
    for name in ("pbx_num_records", "pbx_num_skipped", "pbx_num_u64", "pbx_num_f", "pbx_ins_chars"):
        fn(name, ctypes.c_int64, [ctypes.c_void_p])
    for name, t in (
        ("pbx_u64_values", _u64p), ("pbx_u64_offsets", _u32p), ("pbx_u64_base", _i64p),
        ("pbx_f_values", _f32p), ("pbx_f_offsets", _u32p), ("pbx_f_base", _i64p),
        ("pbx_search_ids", _u64p), ("pbx_cmatch", _i32p), ("pbx_rank", _i32p),
        ("pbx_ins_id_off", _i64p), ("pbx_ins_id_chars_ptr", ctypes.c_char_p),
    ):
        fn(name, t, [ctypes.c_void_p])
    fn("pbx_free", None, [ctypes.c_void_p])
    # --- batch packer
    fn("pbx_packer_create", ctypes.c_void_p,
       [_i32p, _i64p, _u32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64])
    fn("pbx_pack_batch", ctypes.c_int64,
       [ctypes.c_void_p, _i64p, ctypes.c_int64, _i32p, _i32p, _i32p])
    fn("pbx_packer_free", None, [ctypes.c_void_p])
    fn("pbx_gather_f32_slot", None, [
        _f32p, _i64p, _u32p, ctypes.c_int, _i64p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, _f32p,
    ])
    fn("pbx_block_stats", ctypes.c_int, [
        _i32p, _i64p, _i64p, ctypes.c_int64, _i64p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i64p, _i64p,
    ])
    # --- host table store
    fn("pbx_table_create", ctypes.c_void_p, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, _i32p, ctypes.c_int, ctypes.c_float, ctypes.c_char_p,
    ])
    fn("pbx_table_free", None, [ctypes.c_void_p])
    for name in ("pbx_table_size", "pbx_table_mem_rows", "pbx_table_disk_rows"):
        fn(name, ctypes.c_int64, [ctypes.c_void_p])
    fn("pbx_table_pull_or_create", ctypes.c_int, [ctypes.c_void_p, _u64p, ctypes.c_int64, _f32p])
    fn("pbx_table_push", ctypes.c_int, [ctypes.c_void_p, _u64p, _f32p, ctypes.c_int64])
    fn("pbx_table_push_mt", ctypes.c_int,
       [ctypes.c_void_p, _u64p, _f32p, ctypes.c_int64, ctypes.c_int, _i64p])
    fn("pbx_table_io_stats", None, [ctypes.c_void_p, _i64p])
    fn("pbx_table_decay_shrink", ctypes.c_int64, [ctypes.c_void_p, ctypes.c_float, ctypes.c_float])
    fn("pbx_table_spill_cold_ex", ctypes.c_int64,
       [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_float])
    fn("pbx_table_tier_stats", ctypes.c_int64, [ctypes.c_void_p, _i64p])
    fn("pbx_table_compact_spill", ctypes.c_int64, [ctypes.c_void_p])
    fn("pbx_table_spill_stats", None, [ctypes.c_void_p, _i64p, _i64p, _i64p])
    fn("pbx_table_shard_shows", ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int, _f32p, ctypes.c_int64])
    fn("pbx_table_shows_peek", ctypes.c_int, [ctypes.c_void_p, _u64p, ctypes.c_int64, _f32p])
    fn("pbx_table_shard_keys", ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int, _u64p, ctypes.c_int64])
    fn("pbx_table_snapshot_count", ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int, ctypes.c_int])
    fn("pbx_table_snapshot", ctypes.c_int64,
       [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u64p, _f32p])
    fn("pbx_table_clear_touched", None, [ctypes.c_void_p])


def load() -> ctypes.CDLL:
    """The library, built and loaded once per process; raises
    ``RuntimeError`` when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()[0]
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"native host tier: cannot load {path}: {e}") from e
            _declare(lib)
            _lib = lib
        return _lib


def _as_ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def gather_f32_slot(
    f_values: np.ndarray,
    f_base: np.ndarray,
    f_offsets: np.ndarray,
    indices: np.ndarray,
    slot: int,
    dim: int,
) -> np.ndarray:
    """[n, dim] ragged float-slot gather: short rows zero-padded, long rows
    cut (the native tier of ``ColumnarRecords.float_slot_matrix``)."""
    lib = load()
    f_values = np.ascontiguousarray(f_values, dtype=np.float32)
    f_base = np.ascontiguousarray(f_base, dtype=np.int64)
    f_offsets = np.ascontiguousarray(f_offsets, dtype=np.uint32)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.empty((len(indices), dim), np.float32)
    lib.pbx_gather_f32_slot(
        _as_ptr(f_values, ctypes.c_float), _as_ptr(f_base, ctypes.c_int64),
        _as_ptr(f_offsets, ctypes.c_uint32), f_offsets.shape[1],
        _as_ptr(indices, ctypes.c_int64), len(indices), slot, dim,
        _as_ptr(out, ctypes.c_float),
    )
    return out


def block_stats(
    rows: np.ndarray,
    rec_base: np.ndarray,
    key_counts: np.ndarray,
    blocks: np.ndarray,  # int64 [n_blocks, b] record indices
    cap: int,
    ns: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per block (key count L, most unique rows in one of ``ns`` shards of
    ``cap`` rows) over the pass's resolved rows, in one native call."""
    lib = load()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    rec_base = np.ascontiguousarray(rec_base, dtype=np.int64)
    key_counts = np.ascontiguousarray(key_counts, dtype=np.int64)
    blocks = np.ascontiguousarray(blocks, dtype=np.int64)
    # the native sweep trusts every record's key span to lie in ``rows``
    if len(rec_base) != len(key_counts) or (
        len(rec_base)
        and ((rec_base < 0).any() or (key_counts < 0).any() or (rec_base + key_counts > len(rows)).any())
    ):
        raise ValueError("block_stats: record index or row out of range")
    n_blocks, b = blocks.shape
    L_out = np.empty(n_blocks, np.int64)
    bmax_out = np.empty(n_blocks, np.int64)
    rc = lib.pbx_block_stats(
        _as_ptr(rows, ctypes.c_int32), _as_ptr(rec_base, ctypes.c_int64),
        _as_ptr(key_counts, ctypes.c_int64), len(rec_base),
        _as_ptr(blocks, ctypes.c_int64), n_blocks, b, int(cap), int(ns), int(cap) * int(ns),
        _as_ptr(L_out, ctypes.c_int64), _as_ptr(bmax_out, ctypes.c_int64),
    )
    if rc != 0:
        raise ValueError("block_stats: record index or row out of range")
    return L_out, bmax_out


class NativePacker:
    """Handle over one pass's row-resolved columnar records, for one thread.

    ``pack(indices, n_keys)`` -> (uniq_rows [U], inverse [L], segments [L]),
    unpadded, unique rows in first-occurrence order. The arrays the C side
    borrows are kept alive on the instance."""

    def __init__(self, rows: np.ndarray, rec_base: np.ndarray,
                 rec_off: np.ndarray, n_sparse: int, n_table_rows: int):
        lib = load()
        self._lib = lib
        self._rows = np.ascontiguousarray(rows, dtype=np.int32)
        self._base = np.ascontiguousarray(rec_base, dtype=np.int64)
        self._off = np.ascontiguousarray(rec_off, dtype=np.uint32)
        self._h = lib.pbx_packer_create(
            _as_ptr(self._rows, ctypes.c_int32), _as_ptr(self._base, ctypes.c_int64),
            _as_ptr(self._off, ctypes.c_uint32), len(self._base), n_sparse, int(n_table_rows),
        )

    def pack(self, indices: np.ndarray, n_keys: int):
        if not self._h:
            raise RuntimeError("NativePacker used after close()")
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        uniq = np.empty(n_keys, np.int32)
        inv = np.empty(n_keys, np.int32)
        seg = np.empty(n_keys, np.int32)
        U = self._lib.pbx_pack_batch(
            self._h, _as_ptr(indices, ctypes.c_int64), len(indices),
            _as_ptr(uniq, ctypes.c_int32), _as_ptr(inv, ctypes.c_int32),
            _as_ptr(seg, ctypes.c_int32),
        )
        if U < 0:
            raise ValueError("native pack: record index or row out of range")
        return uniq[:U], inv, seg

    def close(self) -> None:
        if self._h:
            self._lib.pbx_packer_free(self._h)
            self._h = None

    def __del__(self):  # close() is the contract; this frees a forgotten handle
        if getattr(self, "_h", None):
            self.close()


class NativeHostStore:
    """Handle over the C++ sharded key -> row store (``csrc/host_table.cc``):
    batch ``pull_or_create`` and ``push`` run natively across shards; a new
    key's row is a pure function of (seed, key). With ``spill_dir`` cold
    rows can be evicted to per-shard disk files and are promoted lazily,
    with the decays they missed applied on the way back."""

    def __init__(
        self,
        n_shards: int,
        width: int,
        show_col: int,
        clk_col: int,
        seed: int,
        init_cols: np.ndarray,
        init_range: float,
        spill_dir: Optional[str] = None,
    ):
        lib = load()
        self._lib = lib
        self.width = width
        self.n_shards = n_shards
        ic = np.ascontiguousarray(init_cols, dtype=np.int32)
        self._h = lib.pbx_table_create(
            n_shards, width, show_col, clk_col, ctypes.c_uint64(seed),
            _as_ptr(ic, ctypes.c_int32), len(ic), float(init_range),
            spill_dir.encode() if spill_dir else None,
        )
        if not self._h:
            raise RuntimeError("native host tier: pbx_table_create failed")

    def __len__(self) -> int:
        return int(self._lib.pbx_table_size(self._h))

    @property
    def mem_rows(self) -> int:
        return int(self._lib.pbx_table_mem_rows(self._h))

    @property
    def disk_rows(self) -> int:
        return int(self._lib.pbx_table_disk_rows(self._h))

    def pull_or_create(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty((len(keys), self.width), np.float32)
        rc = self._lib.pbx_table_pull_or_create(
            self._h, _as_ptr(keys, ctypes.c_uint64), len(keys), _as_ptr(out, ctypes.c_float)
        )
        if rc != 0:
            raise IOError(f"native table pull failed rc={rc}")
        return out

    def push(self, keys: np.ndarray, rows: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        rc = self._lib.pbx_table_push(
            self._h, _as_ptr(keys, ctypes.c_uint64), _as_ptr(rows, ctypes.c_float), len(keys)
        )
        if rc != 0:
            raise IOError(f"native table push failed rc={rc}")

    def push_mt(self, keys: np.ndarray, rows: np.ndarray, threads: int) -> np.ndarray:
        """Push through a pool of ``threads`` writers, each owning a disjoint
        set of shards (bitwise-equal to :meth:`push` at every thread
        count); returns each shard's wall seconds, float64 [n_shards]."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        shard_ns = np.zeros(self.n_shards, np.int64)
        rc = self._lib.pbx_table_push_mt(
            self._h, _as_ptr(keys, ctypes.c_uint64), _as_ptr(rows, ctypes.c_float),
            len(keys), int(threads), _as_ptr(shard_ns, ctypes.c_int64),
        )
        if rc != 0:
            raise IOError(f"native table push failed rc={rc}")
        return shard_ns.astype(np.float64) / 1e9

    def io_stats(self) -> dict:
        """Cumulative writeback and spill IO counters, keyed by
        ``IO_STAT_FIELDS``."""
        out = np.zeros(len(IO_STAT_FIELDS), np.int64)
        self._lib.pbx_table_io_stats(self._h, _as_ptr(out, ctypes.c_int64))
        return {k: int(v) for k, v in zip(IO_STAT_FIELDS, out)}

    def decay_and_shrink(self, decay: float, threshold: float) -> int:
        return int(self._lib.pbx_table_decay_shrink(self._h, decay, threshold))

    def spill_cold(
        self,
        max_mem_rows: int,
        policy: int = SPILL_FIFO,
        pin_show: float = 0.0,
        admit_show: float = 0.0,
    ) -> int:
        """One cap sweep; returns the rows spilled, or the native code when
        negative (-1 tier disabled, -2 IO failure), which the table layer
        turns into its typed error."""
        return int(self._lib.pbx_table_spill_cold_ex(
            self._h, int(max_mem_rows), int(policy), float(pin_show), float(admit_show),
        ))

    def compact_spill(self) -> int:
        """Rewrite the shard spill files keeping only live records; returns
        the live count, or the native code when negative (-1 tier disabled,
        -2 IO failure)."""
        return int(self._lib.pbx_table_compact_spill(self._h))

    def spill_stats(self) -> tuple:
        """(live_records, dead_records, file_bytes) of the disk tier."""
        live, dead, nbytes = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        self._lib.pbx_table_spill_stats(
            self._h, ctypes.byref(live), ctypes.byref(dead), ctypes.byref(nbytes)
        )
        return int(live.value), int(dead.value), int(nbytes.value)

    def tier_stats(self) -> np.ndarray:
        """int64 [n_shards, len(TIER_STAT_FIELDS)]: each shard's occupancy
        and cumulative spill and promote counters, in shard order."""
        out = np.zeros((self.n_shards, len(TIER_STAT_FIELDS)), np.int64)
        if self.n_shards:
            self._lib.pbx_table_tier_stats(self._h, _as_ptr(out, ctypes.c_int64))
        return out

    def shard_shows(self, shard: int) -> np.ndarray:
        """The SHOW column of one shard (memory and disk, the missed decays
        applied), without copying the rows."""
        n = int(self._lib.pbx_table_snapshot_count(self._h, shard, 0))
        out = np.empty(n, np.float32)
        if n:
            got = int(self._lib.pbx_table_shard_shows(
                self._h, shard, _as_ptr(out, ctypes.c_float), n
            ))
            if got < 0:
                raise IOError(f"native shard_shows failed rc={got}")
            out = out[:got]
        return out

    def shows_peek(self, keys: np.ndarray) -> np.ndarray:
        """Decayed shows of a key batch from the memory tier (a key on disk
        or absent reads 0); creates, promotes and touches nothing."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.zeros(len(keys), np.float32)
        if len(keys):
            rc = int(self._lib.pbx_table_shows_peek(
                self._h, _as_ptr(keys, ctypes.c_uint64), len(keys), _as_ptr(out, ctypes.c_float),
            ))
            if rc < 0:
                raise IOError(f"native shows_peek failed rc={rc}")
        return out

    def shard_keys(self, shard: int) -> np.ndarray:
        """Keys of one shard, no values copied."""
        n = int(self._lib.pbx_table_snapshot_count(self._h, shard, 0))
        out = np.empty(n, np.uint64)
        if n:
            got = int(self._lib.pbx_table_shard_keys(
                self._h, shard, _as_ptr(out, ctypes.c_uint64), n
            ))
            out = out[:got]
        return out

    def snapshot_shard(self, shard: int, only_touched: bool, clear_touched: bool):
        """(keys, rows) of one shard, all or only those pushed since the
        touched set was last cleared."""
        n = int(self._lib.pbx_table_snapshot_count(self._h, shard, int(only_touched)))
        keys = np.empty(n, np.uint64)
        vals = np.empty((n, self.width), np.float32)
        if n:
            got = int(self._lib.pbx_table_snapshot(
                self._h, shard, int(only_touched), int(clear_touched),
                _as_ptr(keys, ctypes.c_uint64), _as_ptr(vals, ctypes.c_float),
            ))
            if got < 0:
                raise IOError(f"native table snapshot failed rc={got}")
            keys, vals = keys[:got], vals[:got]
        return keys, vals

    def clear_touched(self) -> None:
        self._lib.pbx_table_clear_touched(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.pbx_table_free(self._h)
            self._h = None

    def __del__(self):  # close() is the contract; this frees a forgotten handle
        self.close()


def _copy(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def parse_buffer_columnar(data: bytes, schema: SlotSchema, stats: Optional[dict] = None):
    """Parse a whole file's bytes natively -> ``ColumnarRecords`` (one copy
    per array, no per-record Python work). A bad line raises ValueError
    with the parser's diagnostic; ``stats["skipped"]`` receives the count of
    records without feasigns."""
    from paddlebox_tpu_torch.data.record_store import ColumnarRecords

    lib = load()
    S = len(schema.slots)
    kinds = (ctypes.c_uint8 * S)(*[1 if s.type == "float" else 0 for s in schema.slots])
    dense = (ctypes.c_uint8 * S)(*[1 if s.dense else 0 for s in schema.slots])
    used = (ctypes.c_uint8 * S)(*[1 if s.used else 0 for s in schema.slots])
    errbuf = ctypes.create_string_buffer(512)
    h = lib.pbx_parse_buffer(
        data, len(data), S, kinds, dense, used,
        1 if schema.parse_ins_id else 0, 1 if schema.parse_logkey else 0,
        errbuf, len(errbuf),
    )
    if not h:
        raise ValueError(f"native slot parse failed: {errbuf.value.decode()}")
    try:
        n = lib.pbx_num_records(h)
        if stats is not None:
            stats["skipped"] = int(lib.pbx_num_skipped(h))
        n_u, n_f = lib.pbx_num_u64(h), lib.pbx_num_f(h)
        Su, Sf = schema.num_sparse, schema.num_float
        ins_off = None
        chars = b""
        if (schema.parse_ins_id or schema.parse_logkey) and n:
            ins_off = _copy(lib.pbx_ins_id_off(h), n + 1, np.int64)
            chars = ctypes.string_at(lib.pbx_ins_id_chars_ptr(h), lib.pbx_ins_chars(h))
        return ColumnarRecords(
            _copy(lib.pbx_u64_values(h), n_u, np.uint64),
            _copy(lib.pbx_u64_offsets(h), n * (Su + 1), np.uint32).reshape(n, Su + 1),
            _copy(lib.pbx_u64_base(h), n, np.int64),
            _copy(lib.pbx_f_values(h), n_f, np.float32),
            _copy(lib.pbx_f_offsets(h), n * (Sf + 1), np.uint32).reshape(n, Sf + 1),
            _copy(lib.pbx_f_base(h), n, np.int64),
            search_ids=_copy(lib.pbx_search_ids(h), n, np.uint64),
            cmatch=_copy(lib.pbx_cmatch(h), n, np.int32),
            rank=_copy(lib.pbx_rank(h), n, np.int32),
            ins_id_off=ins_off,
            ins_id_chars=chars,
        )
    finally:
        lib.pbx_free(h)
