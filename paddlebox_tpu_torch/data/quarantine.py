"""Data-plane fault domain: record quarantine + dead-letter files.

The reference feed tolerates dirty production logs — a malformed line is
counted and skipped, never fatal (SlotPaddleBoxDataFeed::ParseOneInstance
returns false and bumps an error counter; data_feed.cc keeps reading) —
because a bad upstream data drop is the single most common production
incident for a log-fed CTR system. Our parser tier is strict by design
(it is the semantics oracle the native tier is tested against), so the
tolerance lives one layer up, here:

- In ``data_quarantine`` mode (flag, default on) a per-line parse failure
  is CAPTURED, not raised: the original line, file, line number, and
  exception land in a :class:`QuarantineLog`, and the records around it
  keep loading. File-level failures (unreadable file, truncated gz, pipe
  converter death) quarantine the whole file the same way. A missing
  input (``FileNotFoundError``) is NOT quarantined — that is a transient
  fault (late upstream drop) owned by the fs/load retry tier; quarantine
  owns *corruption*, which no retry can heal.
- At the end of the load the log settles into ``PassStats``
  (``bad_lines`` / ``bad_files`` / per-file breakdown) and, when anything
  was quarantined, writes a **dead-letter file**: JSONL under the
  quarantine dir (checkpoint root by default — the supervisor wires
  ``<ckpt_root>/quarantine``), one summary line then one entry per
  quarantined line/file, so an operator can replay or triage the exact
  bytes that were dropped.
- ``begin_pass`` runs a **bounded-loss admission gate**: above
  ``max_bad_line_fraction`` / ``max_bad_file_fraction`` the pass is
  rejected with :class:`DataPoisonedError` — a *deterministic* fault the
  PassSupervisor routes around the transient retry loop (corruption
  replays identically on every retry; see train/supervisor.py
  ``on_poisoned_pass``).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional

from paddlebox_tpu_torch import config

config.define_flag(
    "data_quarantine",
    1,
    "capture per-line parse failures and unreadable part files into a "
    "per-pass dead-letter file instead of aborting the load; begin_pass "
    "then admission-gates the pass on the corrupt fraction. 0 = strict: "
    "the first bad line raises out of load_into_memory",
)
config.define_flag(
    "max_bad_line_fraction",
    0.01,
    "begin_pass admission gate: reject the pass (DataPoisonedError) when "
    "quarantined lines exceed this fraction of all lines read",
)
config.define_flag(
    "max_bad_file_fraction",
    0.2,
    "begin_pass admission gate: reject the pass (DataPoisonedError) when "
    "quarantined (skipped) part files exceed this fraction of the filelist",
)
config.define_flag(
    "data_quarantine_dir",
    "",
    "where dead-letter files land; empty = the dataset's quarantine_dir "
    "(the supervisor wires <checkpoint_root>/quarantine) or a "
    "pbox_quarantine dir under the system temp dir as last resort",
)


class DataPoisonedError(RuntimeError):
    """The pass's input data is corrupt beyond the admission thresholds.

    DETERMINISTIC, unlike the transient faults the retry machinery heals:
    replaying the same filelist hits the same corruption on every attempt,
    so the supervisor never burns its backoff/retry budget on it (see
    ``on_poisoned_pass``). Carries the admission report and the
    dead-letter path naming exactly what was dropped.
    """

    def __init__(
        self,
        detail: str,
        report: Optional[Dict[str, Any]] = None,
        dead_letter: Optional[str] = None,
    ):
        super().__init__(detail)
        self.detail = detail
        self.report = report or {}
        self.dead_letter = dead_letter


def resolve_quarantine_dir(explicit: Optional[str]) -> str:
    """Quarantine dir precedence: dataset arg > flag > tempdir fallback."""
    d = explicit or str(config.get_flag("data_quarantine_dir"))
    if not d:
        d = os.path.join(tempfile.gettempdir(), "pbox_quarantine")
    return d


class QuarantineLog:
    """Thread-safe collector for one load's quarantined lines and files.

    Readers quarantine from the dataset's thread pool, so all state is
    serialized on one lock. Entry storage is bounded (``MAX_KEPT``) so a
    fully corrupt multi-GB file cannot balloon host RAM — counts keep
    accumulating past the cap and the dead-letter summary records the
    truncation.
    """

    MAX_KEPT = 10_000
    MAX_LINE_CHARS = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: List[Dict[str, Any]] = []  # guarded-by: _lock
        self.bad_lines = 0  # guarded-by: _lock
        self.bad_files = 0  # guarded-by: _lock
        self.per_file: Dict[str, int] = {}  # guarded-by: _lock

    def quarantine_line(
        self, path: str, line_no: int, line: str, exc: BaseException
    ) -> None:
        with self._lock:
            self.bad_lines += 1
            self.per_file[path] = self.per_file.get(path, 0) + 1
            if len(self._entries) < self.MAX_KEPT:
                self._entries.append(
                    {
                        "kind": "line",
                        "file": path,
                        "line_no": int(line_no),
                        "line": line[: self.MAX_LINE_CHARS],
                        "error": repr(exc),
                    }
                )

    def quarantine_file(self, path: str, exc: BaseException) -> None:
        with self._lock:
            self.bad_files += 1
            self.per_file.setdefault(path, 0)
            if len(self._entries) < self.MAX_KEPT:
                self._entries.append(
                    {"kind": "file", "file": path, "error": repr(exc)}
                )

    @property
    def total(self) -> int:
        with self._lock:
            return self.bad_lines + self.bad_files

    def settle(self, stats) -> None:
        """Fold the counters into a PassStats (the one accounting path —
        both parser tiers and the file-level skips report through here)."""
        with self._lock:
            stats.bad_lines = self.bad_lines
            stats.bad_files = self.bad_files
            stats.bad_by_file = dict(self.per_file)

    def write(self, dirpath: str, name: str, meta: Dict[str, Any]) -> str:
        """Write the dead-letter file (JSONL: one summary line, then one
        entry per quarantined line/file) and return its path."""
        from paddlebox_tpu_torch.utils.fs import atomic_write

        os.makedirs(dirpath, exist_ok=True)
        path = os.path.join(dirpath, f"{name}.deadletter.jsonl")
        with self._lock:
            summary = {
                "kind": "summary",
                "bad_lines": self.bad_lines,
                "bad_files": self.bad_files,
                "entries": len(self._entries),
                "truncated": self.bad_lines + self.bad_files
                > len(self._entries),
                **meta,
            }
            entries = list(self._entries)
        with atomic_write(path) as f:
            f.write(json.dumps(summary) + "\n")
            for e in entries:
                f.write(json.dumps(e) + "\n")
        return path


def read_dead_letter(path: str) -> Dict[str, Any]:
    """Parse a dead-letter file -> {"summary": dict, "entries": [dict]}.
    The triage/round-trip counterpart of :meth:`QuarantineLog.write`."""
    summary: Dict[str, Any] = {}
    entries: List[Dict[str, Any]] = []
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            obj = json.loads(raw)
            if obj.get("kind") == "summary":
                summary = obj
            else:
                entries.append(obj)
    return {"summary": summary, "entries": entries}
