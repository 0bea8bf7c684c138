"""Least work of the port's two kernels, counted from the work itself.

A row gather of a step reads each of its U distinct keys' ids and rows
once and writes each row out once, at the table's full width: the
kernel returns whole rows (the pull trims them to the pull record's
width afterwards, and the push's read needs every column). The writeback
reads the ids and the U new rows and writes them once. Whatever
implements them, a launch cannot take less than these bytes over the
HBM rate. (The byte arithmetic follows the byte bound of
``chip_smoke.py``'s kernel table: ids, the table rows and the
[U, width] side, each once.)
"""

from __future__ import annotations

from bench_port.core.peaks import HBM_BYTES_PER_S

ID_BYTES = 4  # int32 row ids
F32 = 4


def gather_bytes(u_distinct: int, width: int) -> int:
    return u_distinct * (ID_BYTES + 2 * width * F32)


def writeback_bytes(u_distinct: int, width: int) -> int:
    return u_distinct * (ID_BYTES + 2 * width * F32)


def least_s(n_bytes: float, flops: float = 0.0, peak_flops: float = float("inf")) -> float:
    """The larger of the byte bound and the operation bound."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak_flops)
