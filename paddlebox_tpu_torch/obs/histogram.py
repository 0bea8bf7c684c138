"""Log2-bucketed streaming histograms — the distribution half of the
telemetry plane.

Prometheus-style fixed-boundary histograms force every subsystem to guess
its own bucket layout up front; HDR-style log buckets don't. Each positive
observation lands in the bucket ``[2**(e-1), 2**e)`` chosen by
``math.frexp`` — ~1 bit of relative error, any dynamic range, O(1)
memory per decade — while exact ``count``/``sum``/``min``/``max`` ride
alongside so means and extremes are never estimates. Quantiles are
estimated by rank interpolation inside the owning bucket and clamped to
the exact ``[min, max]``, which keeps them monotone in ``q`` and strictly
positive whenever every observation was.

The class is dependency-free on purpose: ``utils/monitor.py`` imports it
for ``STAT_OBSERVE`` and everything else in the package imports monitor,
so anything this module pulled in would become a package-wide import
cycle.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

# observations at or below zero (timer underflow, a zero-length batch)
# are real data — they get a dedicated bucket keyed by this sentinel
# exponent, below every frexp exponent of a positive float.
_NONPOS_EXP = -5000


def _bucket_exp(value: float) -> int:
    """Exponent ``e`` such that value is in ``[2**(e-1), 2**e)``."""
    if value <= 0.0:
        return _NONPOS_EXP
    # frexp: value = m * 2**e with 0.5 <= m < 1  =>  2**(e-1) <= value < 2**e
    return math.frexp(value)[1]


def _bucket_bounds(exp: int) -> Tuple[float, float]:
    if exp == _NONPOS_EXP:
        return (0.0, 0.0)
    return (math.ldexp(1.0, exp - 1), math.ldexp(1.0, exp))


class Histogram:
    """Thread-safe log2 histogram with exact count/sum/min/max."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}  # guarded-by: _lock
        self._count = 0  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock
        self._min = math.inf  # guarded-by: _lock
        self._max = -math.inf  # guarded-by: _lock

    # -- ingest ----------------------------------------------------------
    def observe(self, value: float) -> None:
        v = float(value)
        exp = _bucket_exp(v)
        with self._lock:
            self._buckets[exp] = self._buckets.get(exp, 0) + 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(v)

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram in (cross-rank / cross-window union)."""
        snap = other._snapshot_locked()
        with self._lock:
            for exp, n in snap["buckets"].items():
                self._buckets[exp] = self._buckets.get(exp, 0) + n
            self._count += snap["count"]
            self._sum += snap["sum"]
            self._min = min(self._min, snap["min"])
            self._max = max(self._max, snap["max"])

    # -- read ------------------------------------------------------------
    def _snapshot_locked(self) -> Dict:
        with self._lock:
            return {
                "buckets": dict(self._buckets),
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
            }

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def min(self) -> float:
        """Exact minimum observed (``inf`` when empty)."""
        with self._lock:
            return self._min

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    def quantile(self, q: float) -> float:
        return self.quantiles([q])[0]

    def quantiles(self, qs: Iterable[float]) -> List[float]:
        """Estimate several quantiles from ONE consistent snapshot.

        Rank interpolation inside the owning log2 bucket, clamped to the
        exact extremes: relative error is bounded by the bucket width
        (~2x worst case, far less in practice because the exact min/max
        pin the tails). Returns ``nan`` per quantile when empty.
        """
        snap = self._snapshot_locked()
        out: List[float] = []
        if snap["count"] == 0:
            return [math.nan for _ in qs]
        ordered = sorted(snap["buckets"].items())
        total = snap["count"]
        for q in qs:
            qc = min(max(float(q), 0.0), 1.0)
            # rank in [0, total-1], numpy 'linear' convention
            rank = qc * (total - 1)
            est = snap["max"]
            cum = 0
            for exp, n in ordered:
                if rank < cum + n:
                    lo, hi = _bucket_bounds(exp)
                    frac = (rank - cum + 0.5) / n  # midpoint-of-rank
                    est = lo + (hi - lo) * frac
                    break
                cum += n
            out.append(min(max(est, snap["min"]), snap["max"]))
        return out

    def summary(self, qs: Iterable[float] = (0.5, 0.9, 0.99)) -> Dict:
        """One JSON-ready dict: exact aggregates + estimated quantiles."""
        snap = self._snapshot_locked()
        qlist = list(qs)
        vals = self.quantiles(qlist) if snap["count"] else []
        s = {
            "count": snap["count"],
            "sum": snap["sum"],
            "min": snap["min"] if snap["count"] else None,
            "max": snap["max"] if snap["count"] else None,
            "mean": (snap["sum"] / snap["count"]) if snap["count"] else None,
        }
        for q, v in zip(qlist, vals):
            s[f"p{_q_label(q)}"] = v
        return s

    # -- (de)serialization ----------------------------------------------
    def to_dict(self) -> Dict:
        snap = self._snapshot_locked()
        return {
            # JSON object keys must be strings; exponents round-trip via str
            "buckets": {str(e): n for e, n in snap["buckets"].items()},
            "count": snap["count"],
            "sum": snap["sum"],
            "min": None if snap["count"] == 0 else snap["min"],
            "max": None if snap["count"] == 0 else snap["max"],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Histogram":
        h = cls()
        h._buckets = {int(e): int(n) for e, n in d.get("buckets", {}).items()}
        h._count = int(d.get("count", 0))
        h._sum = float(d.get("sum", 0.0))
        h._min = math.inf if d.get("min") is None else float(d["min"])
        h._max = -math.inf if d.get("max") is None else float(d["max"])
        return h


def _q_label(q: float) -> str:
    """0.5 -> '50', 0.99 -> '99', 0.999 -> '99.9'."""
    pct = q * 100.0
    if abs(pct - round(pct)) < 1e-9:
        return str(int(round(pct)))
    return ("%g" % pct)


def merge_all(hists: Iterable[Optional[Histogram]]) -> Histogram:
    """Union of histograms (skipping None), e.g. across ranks."""
    out = Histogram()
    for h in hists:
        if h is not None:
            out.merge(h)
    return out
