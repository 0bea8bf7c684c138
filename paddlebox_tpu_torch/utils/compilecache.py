"""Persistent compile cache over the port's run-time builds.

The port compiles one thing at run time: its CUDA kernel libraries.
``ops/cuda_kernels.py`` builds each ``ops/csrc/*.cu`` with ``nvcc`` on
first use, into the package's own ``paddlebox_tpu_torch/_build/``. A fresh
checkout (a new job, a rank started from a fresh copy) pays that ``nvcc``
again. Pointing the cache at a durable directory turns the build into a
cold-vs-warm pair, as the JAX package's persistent XLA cache does for its
compiles: the first process builds and fills the directory, every later
process with the same sources, flags and toolkit loads the library from
it.

This module is the one place that enables it and counts it:

- :func:`enable` points the next kernel build at a directory. The setting
  is process-global and the last enable wins. A library this process has
  already loaded stays loaded, as jax keeps the executables it compiled;
  only later builds look and write there.
- Each build with the cache on is one request, a hit when the keyed
  library is in the directory and a miss otherwise, counted as
  ``compile_cache.*`` stats and through :func:`stats`.

A library's key hashes its source, the ``.cuh`` headers beside it, the
``nvcc`` flags and the toolkit's identity (``nvcc --version``), so an
edited header or a toolkit upgrade misses.

Resolution policy (``compile_cache_dir`` flag): "auto" means "under the
durable checkpoint root": the supervisor resolves it to
``<ckpt_root>/compile_cache`` next to the checkpoints whose job it warms;
entry points without a checkpoint root treat "auto" as off unless a
directory is given. "off", "none" and "" disable it.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.utils.monitor import STAT_GET

config.define_flag(
    "compile_cache_dir",
    "auto",
    "persistent compile cache directory for the CUDA kernel libraries: "
    "'auto' resolves to <checkpoint_root>/compile_cache when a supervisor "
    "owns a checkpoint root (and stays off for root-less entry points "
    "unless set explicitly); 'off' disables; any other value is the cache "
    "directory itself",
)

_lock = threading.Lock()
_state: Dict[str, Optional[str]] = {"dir": None}  # guarded-by: _lock


def resolve_dir(flag_value: str, ckpt_root: Optional[str] = None) -> Optional[str]:
    """compile_cache_dir flag -> concrete directory or None (disabled)."""
    v = (flag_value or "").strip()
    if v in ("", "off", "none"):
        return None
    if v == "auto":
        if ckpt_root:
            return os.path.join(ckpt_root, "compile_cache")
        return None
    return v


def enable(cache_dir: str) -> str:
    """Point the next kernel builds at ``cache_dir`` (made if absent);
    returns its absolute path. Re-pointing is allowed: the last enable
    wins."""
    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    with _lock:
        _state["dir"] = cache_dir
    return cache_dir


def enabled_dir() -> Optional[str]:
    with _lock:
        return _state["dir"]


def disable() -> None:
    """Undo :func:`enable`: later builds go to the package's ``_build/``.
    The setting is process-global, so tests that build a supervisor (which
    enables it under its checkpoint root) use this to keep it from leaking
    into later tests."""
    with _lock:
        _state["dir"] = None


def stats() -> Dict:
    """Counters and the entry census, the JAX package's keys.
    ``hits``/``misses``/``requests`` are process-lifetime; ``entries`` is
    -1 when the directory has gone."""
    d = enabled_dir()
    entries = 0
    if d is not None:
        try:
            # the libraries, not their .lock and .tmp files
            entries = sum(1 for n in os.listdir(d) if n.endswith(".so"))
        # pbox-lint: disable=EXC007 — the -1 label is the record
        except OSError:
            entries = -1
    return {
        "enabled": d is not None,
        "dir": d,
        "hits": int(STAT_GET("compile_cache.hits")),
        "misses": int(STAT_GET("compile_cache.misses")),
        "requests": int(STAT_GET("compile_cache.requests")),
        "entries": entries,
    }
