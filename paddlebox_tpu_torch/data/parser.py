"""Slot-format text line parser.

Line format (parity with SlotPaddleBoxDataFeed::ParseOneInstance,
data_feed.cc:2951-3061):

    [1 <ins_id>] [1 <logkey>] {<num> <v0> <v1> ...} per slot in schema order

- every slot present with its count first; count must be nonzero (pad in the
  data generator)
- uint64 slots drop 0-valued feasigns unless the slot is dense
- float slots drop |v| < 1e-6 unless dense
- logkey is a hex string: cmatch = [11:14), rank = [14:16), search_id = [16:32)
  (parser_log_key, data_feed.cc:2940-2948)

A record with zero remaining uint64 feasigns is rejected (returns None), same
as the reference's ``return (uint64_total_slot_num > 0)``.

Custom parsers: the reference loads user ``.so`` plugins via dlopen
(SlotInsParserMgr data_feed.cc:2594-2655). Here a plugin is any callable
``(line: str, schema) -> SlotRecord | None`` registered with
``register_parser``; the C++ fast path lives in utils/_native (same contract).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np

from paddlebox_tpu_torch.data.slot_record import SlotRecord
from paddlebox_tpu_torch.data.slot_schema import SlotSchema
from paddlebox_tpu_torch.utils.faultinject import fire

_parsers: Dict[str, Callable] = {}


def register_parser(name: str, fn: Callable) -> None:
    _parsers[name] = fn


def get_parser(name: str) -> Callable:
    return _parsers[name]


def _hex_field(log_key: str, name: str, lo: int, hi: int) -> int:
    try:
        return int(log_key[lo:hi], 16)
    except ValueError:
        raise ValueError(
            f"non-hex {name} field {log_key[lo:hi]!r} in log_key {log_key[:64]!r}"
        ) from None


def parse_logkey(log_key: str):
    """-> (search_id, cmatch, rank). Hex sub-fields per the reference layout.

    A short or non-hex key raises a ValueError naming the field and the
    offending value (quarantinable like any other parse error). The length
    floor matches the native tier (csrc/slot_parser.cc: > 16 hex chars), so
    both tiers reject the same keys.
    """
    if len(log_key) <= 16:
        raise ValueError(
            f"log_key too short: need > 16 hex chars, got "
            f"{len(log_key)} ({log_key!r})"
        )
    search_id = _hex_field(log_key, "search_id", 16, 32)
    cmatch = _hex_field(log_key, "cmatch", 11, 14)
    rank = _hex_field(log_key, "rank", 14, 16)
    return search_id, cmatch, rank


def parse_line(line: str, schema: SlotSchema) -> Optional[SlotRecord]:
    fire("parser.parse_line")
    try:
        return _parse_line(line, schema)
    except IndexError:
        raise ValueError(f"truncated slot line (ran out of tokens): {line[:120]!r}")


def _parse_line(line: str, schema: SlotSchema) -> Optional[SlotRecord]:
    toks = line.split()
    pos = 0
    ins_id = ""
    search_id = cmatch = rank = 0
    if schema.parse_ins_id:
        if toks[pos] != "1":
            raise ValueError(f"expected ins_id count 1, got {toks[pos]}")
        ins_id = toks[pos + 1]
        pos += 2
    if schema.parse_logkey:
        if toks[pos] != "1":
            raise ValueError(f"expected logkey count 1, got {toks[pos]}")
        log_key = toks[pos + 1]
        search_id, cmatch, rank = parse_logkey(log_key)
        ins_id = log_key
        pos += 2

    u_vals: list = []
    u_offsets = np.zeros(schema.num_sparse + 1, dtype=np.uint32)
    f_vals: list = []
    f_offsets = np.zeros(schema.num_float + 1, dtype=np.uint32)
    u_slot = f_slot = 0
    for info in schema.slots:
        num = int(toks[pos])
        if num == 0:
            raise ValueError(
                "slot value count can not be zero; pad it in the data generator "
                f"(slot {info.name}, line {line[:80]!r})"
            )
        vals = toks[pos + 1 : pos + 1 + num]
        pos += 1 + num
        if not info.used:
            continue
        if info.type == "float":
            for t in vals:
                v = float(t)
                if abs(v) < 1e-6 and not info.dense:
                    continue
                f_vals.append(v)
            f_slot += 1
            f_offsets[f_slot] = len(f_vals)
        else:
            for t in vals:
                k = int(t)
                if k == 0 and not info.dense:
                    continue
                u_vals.append(k)
            u_slot += 1
            u_offsets[u_slot] = len(u_vals)

    if not u_vals:
        return None
    return SlotRecord(
        u64_values=np.array(u_vals, dtype=np.uint64),
        u64_offsets=u_offsets,
        f_values=np.array(f_vals, dtype=np.float32),
        f_offsets=f_offsets,
        ins_id=ins_id,
        search_id=search_id,
        cmatch=cmatch,
        rank=rank,
    )


class ReplicaCacheLineParser:
    """Line parser for replica-cache datasets (B16 feed integration).

    Parity with SlotPaddleBoxDataFeedWithGpuReplicaCache
    (data_feed.cc:3198-3326): a line starting with ``#`` carries ``dim``
    floats appended to the cache (no record produced); every following
    normal line stores the latest cache row id as the single feasign of
    ``cache_slot`` (the reference hard-codes slot index 3; here it is named).
    The id slot's tokens in the text line are still consumed positionally.

    State is thread-local and reset per file (``begin_file``, invoked by the
    dataset reader): a cache line governs the records after it *within its
    file*; a record before any cache line in its file is an error.
    """

    def __init__(self, cache, cache_slot: str):
        self.cache = cache
        self.cache_slot = cache_slot
        self._tls = threading.local()

    def begin_file(self, path: str) -> None:
        self._tls.offset = None

    def __call__(self, line: str, schema: SlotSchema) -> Optional[SlotRecord]:
        if line.startswith("#"):
            # full token list: a dim mismatch in either direction must raise
            # (add_items validates), not silently truncate
            vals = np.array(line[1:].split(), dtype=np.float32)
            self._tls.offset = self.cache.add_items(vals)
            return None
        rec = parse_line(line, schema)
        if rec is None:
            return None
        offset = getattr(self._tls, "offset", None)
        if offset is None:
            raise ValueError(
                "record line before any '#' cache line in this file"
            )
        s = schema.sparse_slot_index(self.cache_slot)
        new_vals = {s: np.array([offset], dtype=np.uint64)}
        parts = []
        n_slots = len(rec.u64_offsets) - 1
        lens = np.empty(n_slots, dtype=np.int64)
        for i in range(n_slots):
            v = new_vals.get(i)
            if v is None:
                v = rec.slot_keys(i)
            parts.append(v)
            lens[i] = len(v)
        rec.u64_values = np.concatenate(parts).astype(np.uint64, copy=False)
        off = np.zeros(n_slots + 1, dtype=np.uint32)
        np.cumsum(lens, out=off[1:])
        rec.u64_offsets = off
        return rec
