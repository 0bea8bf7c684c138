"""Stage timers.

Port of the JAX package's ``utils/timer.py``: parity with
``platform::Timer`` (platform/timer.h) and the handcrafted stage timers
threaded through the reference's hot paths (per-device pull/push/nccl
timers in DeviceBoxData box_wrapper.h:375-392, reader stage timers
data_feed.h:1731-1736, printed by PrintSyncTimer box_wrapper.cc:1173).
"""

from __future__ import annotations

import threading
import time
from typing import Dict


class Timer:
    """Accumulating start/pause timer (platform::Timer parity)."""

    def __init__(self):
        self._total = 0.0
        self._start: float | None = None
        self._count = 0

    def start(self) -> None:
        self._start = time.perf_counter()

    def pause(self) -> None:
        if self._start is not None:
            self._total += time.perf_counter() - self._start
            self._start = None
            self._count += 1

    def reset(self) -> None:
        self._total = 0.0
        self._start = None
        self._count = 0

    def elapsed_sec(self) -> float:
        run = time.perf_counter() - self._start if self._start is not None else 0.0
        return self._total + run

    def elapsed_ms(self) -> float:
        return self.elapsed_sec() * 1e3

    @property
    def count(self) -> int:
        return self._count


class ScopedTimer:
    """``with ScopedTimer(timer):`` — pause on exit even on error."""

    def __init__(self, timer: Timer):
        self.timer = timer

    def __enter__(self):
        self.timer.start()
        return self.timer

    def __exit__(self, *exc):
        self.timer.pause()


class TimerRegistry:
    """Named stage timers with a one-line report (PrintSyncTimer parity)."""

    def __init__(self):
        self._timers: Dict[str, Timer] = {}
        self._lock = threading.Lock()

    def __getitem__(self, name: str) -> Timer:
        with self._lock:
            t = self._timers.get(name)
            if t is None:
                t = self._timers[name] = Timer()
            return t

    def scope(self, name: str) -> ScopedTimer:
        return ScopedTimer(self[name])

    def report(self) -> str:
        with self._lock:
            items = sorted(self._timers.items())
        return " ".join(
            f"{n}={t.elapsed_sec():.3f}s/{t.count}" for n, t in items
        )

    def as_dict(self) -> Dict[str, float]:
        with self._lock:
            return {n: t.elapsed_sec() for n, t in self._timers.items()}

    def reset(self) -> None:
        with self._lock:
            for t in self._timers.values():
                t.reset()


# global stage timers, mirroring the reference's per-process timer statics
STAGE_TIMERS = TimerRegistry()
