"""The pass-boundary row wire: table rows between the host and the device.

Port of the row wire of the JAX package's ``ops/wire_quant.py``. Full table
rows cross the boundary in four places (the carrier's new-key upload, its
departing-slice fetch, its flush, and the classic writeback of a device
table); the ``wire_dtype`` flag picks their format:

- ``fp32``: exact;
- ``bf16``: every column rounded to bfloat16 (half to even), half the
  bytes;
- ``int8``: the embed-value region (embed_w + embedx, then expand, each
  block with its own per-row max-abs scale) as int8, the rest of the row
  (show/clk counters, extras, AdaGrad g2 sums) as bf16.

The casts are torch casts (``.to(torch.bfloat16)``, ``torch.round``, both
half to even), which give the JAX package's ``ml_dtypes`` / ``np.rint`` /
``jnp.rint`` bits. A NaN goes to int8 as 0, where C++ leaves the cast
undefined; XLA defines it so. Divisions take a tensor divisor: PyTorch's
CUDA division by a scalar multiplies by its reciprocal, which can move the
last bit.

A fetch is split in two: :func:`fetch_rows_start` dispatches the casts on
the caller's current stream and, for a CUDA tensor, the copy into pinned
host memory on a side stream that waits for them, so the copy reads the
values as they stand now and runs beside later work; the source tensors
are held for the side stream with ``record_stream``. :func:`fetch_rows_finish`
waits for that copy and rebuilds fp32 rows with numpy. A send casts on the
host, copies the small payload to the device and rebuilds there.

Every fetch adds to ``wire.fetch_rows_total``, ``wire.fetch_bytes_total``
and ``wire.fetch_fp32_bytes_total``, every send to the ``wire.send_*``
twins.

The mesh wire (``ici_*``, the JAX module's inter-chip half): the
``ici_wire_dtype`` flag picks the format of the sharded pull/push
``all_to_all`` payloads (``parallel/sharded_pullpush.py``): ``fp32``,
``bf16``, ``int8`` (one max-abs scale a record and value section), or
``adaptive``, where each request bucket's first ``ici_hot_slots(K)`` slots
ride bf16 and the rest int8. :func:`ici_effective_mode` applies the
``ici_wire_adaptive`` gate, :func:`ici_wire_nbytes` counts the bytes.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.utils.monitor import STAT_ADD

_MODES = ("fp32", "bf16", "int8")
# the mesh wire also takes the frequency-adaptive mixed mode
_ICI_MODES = _MODES + ("adaptive",)

_side_lock = threading.Lock()
_side_streams: Dict[torch.device, "torch.cuda.Stream"] = {}  # guarded-by: _side_lock


def _check(mode: str) -> str:
    if mode not in _MODES:
        raise ValueError(f"wire dtype {mode!r} not in {_MODES}")
    return mode


def check_ici(mode: str) -> str:
    if mode not in _ICI_MODES:
        raise ValueError(f"ici wire dtype {mode!r} not in {_ICI_MODES}")
    return mode


def ici_effective_mode() -> str:
    """The mesh wire's mode as the collective runs it: ``adaptive`` with
    ``ici_wire_adaptive`` off degrades to fp32 (not to a uniform quantized
    mode), so the off-leg is the default wire bit for bit."""
    from paddlebox_tpu_torch import config

    mode = check_ici(str(config.get_flag("ici_wire_dtype")))
    if mode != "adaptive":
        return mode
    return "adaptive" if config.get_flag("ici_wire_adaptive") else "fp32"


def ici_adaptive_engaged() -> bool:
    """True iff the adaptive wire is live: the one predicate the hotness
    plumbing (the working set's hot bits, the packer's hot-first order)
    reads."""
    return ici_effective_mode() == "adaptive"


def ici_hot_slots(K: int) -> int:
    """The static hot-slot count of a request bucket of K slots: its first
    ``round(ici_hot_frac * K)`` slots ride bf16."""
    from paddlebox_tpu_torch import config

    frac = float(config.get_flag("ici_hot_frac"))
    return int(min(K, max(0, round(frac * K))))


def _embed_span(layout) -> Tuple[int, int]:
    """[start, stop) of the contiguous embed-value region of a table row."""
    return layout.embed_w_col, layout.embed_g2_col


def _embed_blocks(layout) -> Tuple[Tuple[int, int], ...]:
    """The sub-blocks of the embed-value region that quantize with their
    own scales: (embed_w + embedx) and, when present, the expand block."""
    a, b = _embed_span(layout)
    if layout.expand_dim:
        return ((a, layout.expand_col), (layout.expand_col, b))
    return ((a, b),)


def _quantize(blk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 [n, w], f32 scale [n]) of one block: scale = max|x| / 127
    (at least 1e-12 / 127), q = round-half-even(x / scale) in [-127, 127]."""
    scale = torch.div(
        torch.clamp_min(blk.abs().amax(dim=1), 1e-12),
        torch.full((), 127.0, dtype=blk.dtype, device=blk.device),
    )
    q = torch.clamp(torch.round(blk / scale[:, None]), -127.0, 127.0)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), scale


def _encode(arr: torch.Tensor, layout, mode: str) -> Dict[str, torch.Tensor]:
    """fp32 rows [n, width] -> the wire's tensors, on arr's device."""
    if mode == "fp32":
        return {"raw": arr}
    if mode == "bf16":
        return {"raw": arr.to(torch.bfloat16)}
    a, b = _embed_span(layout)
    qs, scales = zip(*(_quantize(arr[:, ba:bb]) for ba, bb in _embed_blocks(layout)))
    return {
        "q": torch.cat(qs, dim=1),
        "scale": torch.stack(scales, dim=1),  # [n, n_blocks]
        "head": arr[:, :a].to(torch.bfloat16),
        "tail": arr[:, b:].to(torch.bfloat16),
    }


def _count(prefix: str, n: int, layout, mode: str) -> None:
    STAT_ADD(f"wire.{prefix}_rows_total", n)
    STAT_ADD(f"wire.{prefix}_bytes_total", row_wire_nbytes(n, layout, mode))
    STAT_ADD(f"wire.{prefix}_fp32_bytes_total", row_wire_nbytes(n, layout, "fp32"))


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    with _side_lock:
        s = _side_streams.get(device)
        if s is None:
            s = _side_streams[device] = torch.cuda.Stream(device)
        return s


# ---- table-row wire (boundary transfers) ------------------------------------


def fetch_rows_start(arr: torch.Tensor, layout, mode: str) -> dict:
    """fp32 rows [n, width] on the device -> a wire handle.

    The casts are queued now on the current stream; for a CUDA tensor the
    copy to pinned host memory is queued on a side stream behind them, so
    the handle holds the rows as they are now. Nothing blocks until
    :func:`fetch_rows_finish`. On a CPU tensor the handle holds the cast
    tensors themselves, so the caller must not write to ``arr`` before the
    finish."""
    mode = _check(mode)
    _count("fetch", arr.shape[0], layout, mode)
    parts = _encode(arr, layout, mode)
    if not arr.is_cuda:
        return {"mode": mode, "host": parts, "done": None}
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(arr.device))
    side = _side_stream(arr.device)
    host = {}
    with torch.cuda.stream(side):
        side.wait_event(ready)
        for k, v in parts.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
            v.record_stream(side)  # the allocator keeps v until the copy ran
        done = torch.cuda.Event()
        done.record(side)
    return {"mode": mode, "host": host, "done": done}


def fetch_rows_finish(handle: dict, layout) -> np.ndarray:
    """Wait for a wire handle's copy -> host fp32 [n, width]."""
    if handle["done"] is not None:
        handle["done"].synchronize()
    mode, host = handle["mode"], handle["host"]
    if mode == "fp32":
        return host["raw"].numpy()
    if mode == "bf16":
        return host["raw"].float().numpy()
    a, b = _embed_span(layout)
    q = host["q"].numpy().astype(np.float32)
    scale = host["scale"].numpy()
    out = np.empty((q.shape[0], layout.width), dtype=np.float32)
    out[:, :a] = host["head"].float().numpy()
    for bi, (ba, bb) in enumerate(_embed_blocks(layout)):
        out[:, ba:bb] = q[:, ba - a : bb - a] * scale[:, bi : bi + 1]
    out[:, b:] = host["tail"].float().numpy()
    return out


def fetch_rows(arr: torch.Tensor, layout, mode: str) -> np.ndarray:
    """Device fp32 rows -> host fp32 rows over the wire, in one call."""
    return fetch_rows_finish(fetch_rows_start(arr, layout, mode), layout)


def send_rows(arr: np.ndarray, layout, mode: str, device) -> torch.Tensor:
    """Host fp32 [n, width] -> fp32 [n, width] on ``device`` over the wire:
    the casts run on the host, only the wire's payload is copied, and the
    device rebuilds the rows."""
    mode = _check(mode)
    _count("send", arr.shape[0], layout, mode)
    host = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    if mode == "fp32":
        return host.to(device, copy=True)
    parts = {k: v.to(device) for k, v in _encode(host, layout, mode).items()}
    if mode == "bf16":
        return parts["raw"].float()
    a, b = _embed_span(layout)
    q = parts["q"].float()
    out = torch.empty((arr.shape[0], layout.width), dtype=torch.float32, device=device)
    out[:, :a] = parts["head"].float()
    for bi, (ba, bb) in enumerate(_embed_blocks(layout)):
        out[:, ba:bb] = q[:, ba - a : bb - a] * parts["scale"][:, bi : bi + 1]
    out[:, b:] = parts["tail"].float()
    return out


def row_wire_nbytes(n: int, layout, mode: str) -> int:
    """Bytes crossing the wire for n table rows under a mode."""
    mode = _check(mode)
    w = layout.width
    if mode == "fp32":
        return n * w * 4
    if mode == "bf16":
        return n * w * 2
    a, b = _embed_span(layout)
    n_blocks = len(_embed_blocks(layout))
    # int8 region + bf16 rest + one fp32 scale per block
    return n * ((b - a) + (w - (b - a)) * 2 + 4 * n_blocks)


def ici_wire_nbytes(
    n: int, K: int, W: int, head: int, n_sections: int, mode: str, hot_slots: int = 0
) -> int:
    """Bytes of an [n, K, W] record block on the mesh wire.

    The ``head`` columns ride fp32 (the pull's counters, the push's
    show/clk); the other W - head value columns ride the mode's format.
    An int8 record carries one fp32 scale a section. ``adaptive`` splits
    each bucket at ``hot_slots``: bf16 before, int8 after, and is the
    uniform int8 / bf16 wire at H = 0 / H = K."""
    mode = check_ici(mode)
    q_cols = W - head
    if mode == "fp32":
        return n * K * W * 4
    if mode == "bf16":
        return n * K * (head * 4 + q_cols * 2)
    if mode == "int8":
        return n * K * (head * 4 + q_cols + 4 * n_sections)
    H = int(hot_slots)
    if H <= 0:
        return ici_wire_nbytes(n, K, W, head, n_sections, "int8")
    if H >= K:
        return ici_wire_nbytes(n, K, W, head, n_sections, "bf16")
    return n * (K * head * 4 + H * q_cols * 2 + (K - H) * (q_cols + 4 * n_sections))
