"""Event profiler with chrome-trace export.

Port of the JAX package's ``utils/trace.py`` (the reference's event
profiler, platform/profiler.{h,cc}: ``RecordEvent`` scoped annotations,
profiler.h:127, and its chrome-trace exporter, tools/timeline.py:115-137).
This host-side layer times the Python stages around the device (pack,
upload, dispatch, the pass boundary) and writes ``chrome://tracing`` JSON;
``device_trace`` wraps ``torch.profiler`` for the kernels themselves.

- the event buffer is a bounded ring (flag ``trace_max_events``); when
  full, the oldest events are dropped and counted in
  ``trace.dropped_events``;
- tids are small per-thread ids (1, 2, ...) with chrome ``thread_name``
  metadata, and ``set_process(rank)`` stamps pid=rank and a
  ``process_name``;
- every span and instant also feeds the always-on flight recorder
  (``obs/flight_recorder.py``), tracing enabled or not;
- spans recorded inside an ``obs.trace_context.trace_span`` carry
  trace_id/span_id args.

A span costs two ``perf_counter_ns`` reads and a ring append: it never
waits for the device. Code that wants device time inside a span (the
trainer's ``device_step`` under ``profile``) synchronizes the stream
itself.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List, Optional

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.obs.flight_recorder import FLIGHT_RECORDER
from paddlebox_tpu_torch.obs.trace_context import current_trace
from paddlebox_tpu_torch.utils.monitor import STAT_ADD

config.define_flag(
    "trace_max_events", 200_000,
    "profiler ring capacity per process; once full the oldest data "
    "events are dropped (counted in trace.dropped_events)",
)


def _trace_args() -> Optional[Dict[str, str]]:
    ctx = current_trace()
    return ctx.as_args() if ctx is not None else None


class Profiler:
    def __init__(self, max_events: Optional[int] = None):
        self._lock = threading.Lock()
        self._max_events = max_events  # None -> flag trace_max_events
        # ring state: touched only by the *_locked helpers below, whose
        # callers all hold _lock (THR002 can't see through the helpers)
        self._events: Deque[Dict] = deque()  # synchronized-by: _lock (held by *_locked callers)
        self._thread_meta: List[Dict] = []  # synchronized-by: _lock (held by *_locked callers)
        self._tids: Dict[int, int] = {}  # synchronized-by: _lock (held by *_locked callers)
        self._dropped = 0  # synchronized-by: _lock (held by *_locked callers)
        self._pid = 0  # guarded-by: _lock
        self._process_name = "rank0"  # guarded-by: _lock
        self.enabled = False

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def set_process(self, rank: int, name: Optional[str] = None) -> None:
        """Label this process's rows: pid=rank, a readable process_name.
        Events are stamped with the pid at export, so calling this after
        spans were already recorded still yields one coherent row."""
        with self._lock:
            self._pid = int(rank)
            self._process_name = name or f"rank{int(rank)}"
        FLIGHT_RECORDER.set_rank(int(rank))

    @property
    def dropped_events(self) -> int:
        with self._lock:
            return self._dropped

    # -- recording --------------------------------------------------------
    def _tid_locked(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[ident] = tid
            self._thread_meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                }
            )
        return tid

    def _append_locked(self, event: Dict) -> None:
        cap = self._max_events
        if cap is None:
            cap = int(config.get_flag("trace_max_events"))
        while len(self._events) >= max(1, cap):
            self._events.popleft()
            self._dropped += 1
            STAT_ADD("trace.dropped_events")
        self._events.append(event)

    @contextmanager
    def record_event(self, name: str, category: str = "host"):
        """Scoped annotation (platform::RecordEvent parity). Always feeds
        the flight recorder; appends to the trace only when enabled."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            args = _trace_args()
            FLIGHT_RECORDER.note_span(
                name, category, t0 / 1e3, (t1 - t0) / 1e3, args)
            if self.enabled:
                event = {
                    "name": name,
                    "cat": category,
                    "ph": "X",
                    "ts": t0 / 1e3,  # chrome trace wants microseconds
                    "dur": (t1 - t0) / 1e3,
                }
                if args:
                    event["args"] = args
                with self._lock:
                    event["tid"] = self._tid_locked()
                    self._append_locked(event)

    def instant(self, name: str, args: Optional[Dict] = None,
                category: str = "incident") -> None:
        """Zero-duration structured event (chrome trace "i" phase): the
        supervisor's incident log lands in the same timeline as the pass
        stages it interrupted, with the details in ``args``. Instants feed
        the flight recorder, tracing enabled or not: incident-category
        ones into the incident ring, the rest (transport markers etc.)
        into the span ring as zero-duration entries."""
        merged = dict(args or {})
        tctx = _trace_args()
        if tctx:
            merged.update(tctx)
        if category == "incident":
            FLIGHT_RECORDER.note_incident(name, merged, category)
        else:
            FLIGHT_RECORDER.note_span(
                name, category, time.perf_counter_ns() / 1e3, 0.0, merged)
        if not self.enabled:
            return
        event = {
            "name": name,
            "cat": category,
            "ph": "i",
            "s": "g",  # global scope: draw the incident across rows
            "ts": time.perf_counter_ns() / 1e3,
            "args": merged,
        }
        with self._lock:
            event["tid"] = self._tid_locked()
            self._append_locked(event)

    # -- export -----------------------------------------------------------
    def export_chrome_trace(self, path: str) -> int:
        """Write chrome://tracing JSON (timeline.py parity). Returns the
        number of DATA events written (metadata rows excluded)."""
        from paddlebox_tpu_torch.utils.fs import atomic_write

        with self._lock:
            data = [dict(e) for e in self._events]
            thread_meta = [dict(m) for m in self._thread_meta]
            pid = self._pid
            pname = self._process_name
            dropped = self._dropped
        meta = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": pname}},
            {"name": "process_sort_index", "ph": "M", "pid": pid, "tid": 0,
             "args": {"sort_index": pid}},
        ]
        for m in thread_meta:
            m["pid"] = pid
        for e in data:
            e["pid"] = pid
        payload = {
            "traceEvents": meta + thread_meta + data,
            "displayTimeUnit": "ms",
            "otherData": {"rank": pid, "dropped_events": dropped},
        }
        with atomic_write(path) as f:
            json.dump(payload, f)
        return len(data)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._thread_meta.clear()
            self._tids.clear()
            self._dropped = 0


# process-global profiler, like the reference's g_state
PROFILER = Profiler()


def record_event(name: str, category: str = "host"):
    return PROFILER.record_event(name, category)


@contextmanager
def device_trace(log_dir: Optional[str] = None, device=None):
    """Trace a region with ``torch.profiler`` (CPU and, on a CUDA device,
    CUDA activities) and export a chrome trace into ``log_dir``
    (``device_trace.json``); the nvprof hook's analog
    (platform/cuda_profiler.h). Yields the profiler (its
    ``key_averages()`` and ``events()`` name the kernels), or None when
    ``log_dir`` is None, which traces nothing."""
    if log_dir is None:
        yield None
        return
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    dev = torch.device(device) if device is not None else None
    if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.profiler.ProfilerActivity.CUDA in acts:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "device_trace.json"))
