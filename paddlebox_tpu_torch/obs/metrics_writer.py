"""Metric series: rank-tagged JSONL snapshots of the stat registry.

Every snapshot is one JSON line — wall time, rank, a label (``pass:<n>``
at pass boundaries, ``tick`` on the wall-clock cadence), the full counter
registry, per-window DELTAS for every numeric counter (what happened
since the previous snapshot, not just the monotone absolute), and a
summary of every histogram. ``tools/obs_report.py`` renders the series
into per-pass tables and SLO verdicts; ``read_series`` is the parsing
half it uses.

Durability model: lines are appended with flush (a torn final line after
a crash is skipped — and counted — by ``read_series``); rotation renames
the live file to ``metrics-<rank>.<seq>.jsonl`` via ``os.replace``, the
same atomic publish primitive as ``utils/fs.atomic_write``, so a reader
never observes a half-rotated file.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, all_histograms, all_stats

config.define_flag(
    "obs_metrics_interval_s", 30.0,
    "wall-clock cadence for metric-series snapshots between pass "
    "boundaries (maybe_snapshot); <= 0 disables the cadence",
)
config.define_flag(
    "obs_metrics_rotate_bytes", 8 << 20,
    "rotate metrics-<rank>.jsonl once it would exceed this many bytes",
)

_ROTATED_RE = re.compile(r"metrics-(\d+)\.(\d+)\.jsonl$")


class MetricsWriter:
    """Appends registry snapshots to ``<out_dir>/metrics-<rank>.jsonl``."""

    def __init__(
        self,
        out_dir: str,
        rank: int = 0,
        interval_s: Optional[float] = None,
        rotate_bytes: Optional[int] = None,
    ) -> None:
        self.out_dir = out_dir
        self.rank = int(rank)
        self._interval_s = interval_s
        self._rotate_bytes = rotate_bytes
        self._lock = threading.Lock()
        self._prev: Dict[str, Any] = {}  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._rotations = 0  # synchronized-by: _lock (held by _rotate_locked callers)
        self._last_write = 0.0  # guarded-by: _lock
        os.makedirs(out_dir, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.out_dir, f"metrics-{self.rank}.jsonl")

    def _cfg_interval(self) -> float:
        if self._interval_s is not None:
            return float(self._interval_s)
        return float(config.get_flag("obs_metrics_interval_s"))

    def _cfg_rotate(self) -> int:
        if self._rotate_bytes is not None:
            return int(self._rotate_bytes)
        return int(config.get_flag("obs_metrics_rotate_bytes"))

    def snapshot(self, label: str,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Write one series record now; returns the record."""
        counters = all_stats()
        hists = {
            name: h.summary((0.5, 0.9, 0.99))
            for name, h in all_histograms().items()
        }
        with self._lock:
            deltas = {
                k: v - self._prev.get(k, 0)
                for k, v in counters.items()
                if isinstance(v, (int, float))
            }
            self._seq += 1
            record = {
                "t": time.time(),
                "rank": self.rank,
                "seq": self._seq,
                "label": label,
                "counters": counters,
                "deltas": deltas,
                "histograms": hists,
            }
            if extra:
                record["extra"] = extra
            self._prev = counters
            line = json.dumps(record) + "\n"
            self._rotate_locked(len(line))
            # append-only local series: a torn tail line after a crash is
            # tolerated (read_series skips and counts it), and rotation
            # publishes finished segments atomically via os.replace
            # pbox-lint: disable=IO004
            with open(self.path, "a") as f:
                f.write(line)
                f.flush()
            self._last_write = time.monotonic()
        STAT_ADD("obs.metrics_snapshots")
        return record

    def maybe_snapshot(self, label: str = "tick") -> Optional[Dict[str, Any]]:
        """Snapshot iff the wall-clock cadence elapsed since the last
        write (any label). Cheap to call from a training loop."""
        interval = self._cfg_interval()
        if interval <= 0:
            return None
        with self._lock:
            due = time.monotonic() - self._last_write >= interval
        if not due:
            return None
        return self.snapshot(label)

    def _rotate_locked(self, incoming: int) -> None:
        limit = self._cfg_rotate()
        try:
            size = os.path.getsize(self.path)
        except FileNotFoundError:
            return  # no live file yet -> nothing to rotate
        if size == 0 or size + incoming <= limit:
            return
        self._rotations += 1
        rotated = os.path.join(
            self.out_dir, f"metrics-{self.rank}.{self._rotations}.jsonl"
        )
        os.replace(self.path, rotated)
        STAT_ADD("obs.metrics_rotations")

    @property
    def rotations(self) -> int:
        with self._lock:
            return self._rotations


def series_files(out_dir: str, rank: Optional[int] = None) -> List[str]:
    """All series segments in read order: rotated (by segment number)
    then live, grouped per rank."""
    pat = f"metrics-{rank}" if rank is not None else "metrics-*"
    paths = glob.glob(os.path.join(out_dir, pat + ".jsonl")) + glob.glob(
        os.path.join(out_dir, pat + ".*.jsonl")
    )

    def key(p: str):
        m = _ROTATED_RE.search(p)
        if m:
            return (int(m.group(1)), 0, int(m.group(2)))
        base = os.path.basename(p)
        r = base[len("metrics-"):-len(".jsonl")]
        return (int(r) if r.isdigit() else 1 << 30, 1, 0)

    return sorted(set(paths), key=key)


def series_ranks(out_dir: str) -> List[int]:
    """Distinct ranks with any series segment (live or rotated)."""
    ranks = set()
    for p in series_files(out_dir):
        m = _ROTATED_RE.search(p)
        if m:
            ranks.add(int(m.group(1)))
            continue
        r = os.path.basename(p)[len("metrics-"):-len(".jsonl")]
        if r.isdigit():
            ranks.add(int(r))
    return sorted(ranks)


def read_series(out_dir: str, rank: Optional[int] = None,
                ) -> Iterator[Dict[str, Any]]:
    """Parse every record back, across rotations, skipping (and counting
    in ``obs.metrics_bad_lines``) torn or malformed lines."""
    for path in series_files(out_dir, rank):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    STAT_ADD("obs.metrics_bad_lines")
