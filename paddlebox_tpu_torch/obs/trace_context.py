"""Trace-context propagation: (trace_id, span_id) per logical operation.

Port of the JAX package's ``obs/trace_context.py``. A rank opens a trace
around a logical operation (a shuffle round, a verdict, a delta publish);
every profiler span recorded inside picks up the ids as chrome-trace
``args``. The host transport (ROADMAP Queue 1 item 5.3) will stamp them on
its frames as a 24-byte header extension (``encode_ext`` /
``decode_ext``), byte for byte the JAX package's, so a receiving rank's
events carry the same trace_id.

Context is per-thread (``threading.local``). Ids are random
(``os.urandom``): 128-bit trace, 64-bit span, hex in args and fixed-width
binary on the wire. Stdlib only: ``utils/trace.py`` imports this module.
"""

from __future__ import annotations

import os
import struct
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

# wire form of one context: 16B trace_id + 8B span_id, big-endian-ish raw
# bytes (opaque ids — byte order only matters for hex round-trip).
EXT_STRUCT = struct.Struct("<16s8s")
EXT_LEN = EXT_STRUCT.size  # 24


class TraceContext:
    """Immutable (trace_id, span_id) pair. Ids are raw bytes."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: bytes, span_id: bytes) -> None:
        self.trace_id = trace_id
        self.span_id = span_id

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(os.urandom(16), os.urandom(8))

    def child(self) -> "TraceContext":
        """Same trace, fresh span — a step inside the operation."""
        return TraceContext(self.trace_id, os.urandom(8))

    @property
    def trace_id_hex(self) -> str:
        return self.trace_id.hex()

    @property
    def span_id_hex(self) -> str:
        return self.span_id.hex()

    def as_args(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id_hex, "span_id": self.span_id_hex}

    def encode_ext(self) -> bytes:
        return EXT_STRUCT.pack(self.trace_id, self.span_id)


def decode_ext(raw: bytes) -> "TraceContext":
    trace_id, span_id = EXT_STRUCT.unpack(raw)
    return TraceContext(trace_id, span_id)


_tls = threading.local()


def current_trace() -> Optional[TraceContext]:
    """The thread's active context, or None outside any trace_span."""
    return getattr(_tls, "ctx", None)


@contextmanager
def trace_span(name: str = "", ctx: Optional[TraceContext] = None,
               ) -> Iterator[TraceContext]:
    """Activate a context for the with-block.

    No explicit ``ctx``: continue the current trace with a child span
    (or start a brand-new trace at the root). With ``ctx`` (e.g. decoded
    off an incoming frame): adopt the remote trace so local spans
    correlate cross-rank. ``name`` is documentation only — the profiler
    spans recorded inside carry the actual labels.
    """
    prev = current_trace()
    if ctx is None:
        ctx = prev.child() if prev is not None else TraceContext.new()
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev
