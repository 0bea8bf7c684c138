"""Always-on incident flight recorder.

A fixed-size in-memory ring of the most recent profiler spans, instants,
and incident notes — fed unconditionally (tracing enabled or not) by
``utils/trace.py`` — plus a one-call ``dump()`` that publishes an atomic
``incident-<ts>.json`` bundle (recent spans + incidents + a full stat and
histogram snapshot) when something fatal happens: DataPoisonedError,
PeerDeadError, CoordinatedAbort, a wedged backend init. Postmortems no
longer depend on having had tracing enabled in advance: the last N spans
before the death are always there.

The ring is deliberately tiny (flag ``obs_flight_spans``) and lock-cheap;
the expensive parts (stat snapshot, JSON encode, fsync) only run at dump
time, i.e. when the process is already dying or aborting a pass.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, all_histograms, all_stats

config.define_flag(
    "obs_flight_spans", 256,
    "flight-recorder ring capacity: how many recent spans survive into "
    "an incident bundle",
)
config.define_flag(
    "obs_incident_dir", "",
    "directory for incident-<ts>.json flight-recorder bundles; empty "
    "disables dumping (the in-memory ring still records)",
)


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._capacity = capacity  # None -> flag, resolved lazily
        self._spans: Optional[Deque[Dict]] = None  # guarded-by: _lock
        self._incidents: Deque[Dict] = deque(maxlen=64)  # guarded-by: _lock
        self._rank = 0  # guarded-by: _lock

    def set_rank(self, rank: int) -> None:
        with self._lock:
            self._rank = int(rank)

    # -- feed (called from utils/trace.py on every span/instant) ---------
    def note_span(self, name: str, category: str, ts_us: float,
                  dur_us: float, args: Optional[Dict] = None) -> None:
        rec = {"name": name, "cat": category, "ts": ts_us, "dur": dur_us,
               "thread": threading.current_thread().name}
        if args:
            rec["args"] = args
        with self._lock:
            if self._spans is None:  # lazy: capacity flag resolved on first use
                cap = self._capacity
                if cap is None:
                    cap = int(config.get_flag("obs_flight_spans"))
                self._spans = deque(maxlen=max(1, cap))
            self._spans.append(rec)

    def note_incident(self, kind: str, args: Optional[Dict] = None,
                      category: str = "incident") -> None:
        rec = {"kind": kind, "cat": category, "wall_time": time.time(),
               "args": args or {}}
        with self._lock:
            self._incidents.append(rec)

    # -- read / dump ------------------------------------------------------
    def snapshot(self) -> Dict:
        """The bundle content, without writing anything."""
        with self._lock:
            spans = list(self._spans) if self._spans is not None else []
            incidents = list(self._incidents)
            rank = self._rank
        return {
            "rank": rank,
            "wall_time": time.time(),
            "spans": spans,
            "incidents": incidents,
            "stats": all_stats(),
            "histograms": {
                name: h.to_dict() for name, h in all_histograms().items()
            },
        }

    def dump(self, reason: str, detail: str = "",
             dir_path: Optional[str] = None) -> Optional[str]:
        """Write ``incident-<ts>.json`` atomically; returns the path, or
        None when no dump directory is configured. Never raises: a dump
        runs inside fatal-error handling, and masking the original
        PeerDeadError/DataPoisonedError with an IO error would be worse
        than losing the bundle."""
        out_dir = dir_path if dir_path is not None else str(
            config.get_flag("obs_incident_dir"))
        if not out_dir:
            return None
        bundle = self.snapshot()
        bundle["reason"] = reason
        bundle["detail"] = detail
        path = os.path.join(out_dir, f"incident-{time.time_ns()}.json")
        try:
            from paddlebox_tpu_torch.utils.fs import atomic_write

            os.makedirs(out_dir, exist_ok=True)
            with atomic_write(path) as f:
                json.dump(bundle, f)
        except OSError:
            # counted, not raised: see docstring
            STAT_ADD("obs.incident_dump_errors")
            return None
        STAT_ADD("obs.incident_dumps")
        return path

    def reset(self) -> None:
        """Clear the rings and re-resolve capacity from the flag."""
        with self._lock:
            self._spans = None
            self._incidents.clear()


# process-global recorder, fed by the global PROFILER
FLIGHT_RECORDER = FlightRecorder()


def recent_incidents() -> List[Dict]:
    return FLIGHT_RECORDER.snapshot()["incidents"]
