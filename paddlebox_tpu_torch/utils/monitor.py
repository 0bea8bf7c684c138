"""Process-wide stat registry.

Parity with ``Monitor``/``StatRegistry`` (platform/monitor.h:43-153): named
int/float counters bumped from anywhere via STAT_ADD / read via STAT_GET /
zeroed via STAT_RESET — e.g. the reference's
``STAT_total_feasign_num_in_mem`` (box_wrapper.cc:1282).
"""

from __future__ import annotations

import threading
from typing import Dict, Union

from paddlebox_tpu_torch.obs.histogram import Histogram

Number = Union[int, float]

_lock = threading.Lock()
_stats: Dict[str, Number] = {}  # guarded-by: _lock
_hists: Dict[str, Histogram] = {}  # guarded-by: _lock


def STAT_ADD(name: str, value: Number = 1) -> None:
    with _lock:
        _stats[name] = _stats.get(name, 0) + value


def STAT_SET(name: str, value: Number) -> None:
    with _lock:
        _stats[name] = value


def STAT_GET(name: str) -> Number:
    with _lock:
        return _stats.get(name, 0)


def STAT_OBSERVE(name: str, value: Number) -> None:
    """Record one sample into the named distribution (latency, frame
    size, stage seconds, ...). Same literal-name discipline as STAT_ADD
    (MON005); the histogram itself is log2-bucketed with exact
    count/sum/min/max — see ``obs/histogram.py``."""
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = Histogram()
    # Histogram carries its own lock; observing outside _lock keeps the
    # registry lock off the hot path.
    h.observe(value)


def STAT_HIST(name: str) -> Histogram | None:
    """The named histogram, or None if nothing was ever observed."""
    with _lock:
        return _hists.get(name)


def STAT_RESET(name: str | None = None) -> None:
    with _lock:
        if name is None:
            _stats.clear()
            _hists.clear()
        else:
            _stats.pop(name, None)
            _hists.pop(name, None)


def all_stats(prefix: str | None = None) -> Dict[str, Number]:
    """Snapshot of the registry; ``prefix`` filters to one dashboard
    namespace (e.g. ``"serve."`` for the serving plane's counters)."""
    with _lock:
        snap = dict(_stats)
    if prefix is None:
        return snap
    return {k: v for k, v in snap.items() if k.startswith(prefix)}


def all_histograms(prefix: str | None = None) -> Dict[str, Histogram]:
    """Snapshot of the distribution registry (live Histogram objects —
    they are individually thread-safe; use ``h.summary()``/``to_dict()``
    for a point-in-time view)."""
    with _lock:
        snap = dict(_hists)
    if prefix is None:
        return snap
    return {k: v for k, v in snap.items() if k.startswith(prefix)}
