"""Crash-safe local file publishing.

Port of ``atomic_write`` from the JAX package's ``utils/fs.py``, which the
checkpoint chain and the dense files write through. The remote pipes
(``hdfs:``/``afs:``), the converters and the file manager wait for a later
slice; a remote path is refused here as it is there.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire

_REMOTE_PREFIXES = ("hdfs:", "afs:")


def is_remote(path: str) -> bool:
    return path.startswith(_REMOTE_PREFIXES)


@contextmanager
def atomic_write(path: str, mode: str = "w"):
    """Crash-safe local write: stream into ``path + ".tmp"``, publish with
    ``os.replace`` only after the block exits cleanly. A crash anywhere in
    the window leaves the previous ``path`` intact; the torn bytes land in
    the tmp file, which the next successful publish overwrites.

    Local paths only (``os.replace`` has no remote analogue). ``mode`` is
    ``"w"`` or ``"wb"``. The fault site ``fs.atomic_write`` fires between
    the write and the publish, the window the atomicity claim is about.
    """
    if is_remote(path):
        raise ValueError(f"atomic_write is local-only, got {path!r}")
    if mode not in ("w", "wb"):
        raise ValueError(f"atomic_write mode must be 'w' or 'wb', got {mode!r}")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, mode) as f:
        yield f
        f.flush()
        os.fsync(f.fileno())
    _fault_fire("fs.atomic_write")
    os.replace(tmp, path)
