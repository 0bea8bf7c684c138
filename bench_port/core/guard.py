"""The run's guard against the JAX package: no module of ``jax``,
``jaxlib``, ``flax`` or the JAX package may be loaded in the process that
prints the result. Compared by whole top-level name (the part before the
first dot): ``paddlebox_tpu_torch``, the port, begins with the JAX
package's name and is not it."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "paddlebox_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
