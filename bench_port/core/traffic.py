"""The one generator of the benchmark's traffic.

A traffic mix is a JSON file under ``bench_port/traffic/``; this module
reads its parameters and makes the records of a pass from the seed. The
key draw is bench.py's ``write_files``: each slot takes one key, a hot
head of ``hot_keys`` keys drawn ``hot_frac`` of the time and otherwise a
key uniform over ``[1, key_space)``. Every slot draws from the same
keys: the per-field cardinalities of Criteo's columns are not modelled.
A label is 1 with probability ``pos_frac``. A dense slot holds
``log1p`` of exponential counts (mean 8), as Criteo's numeric columns are
usually fed, kept to four decimals so the text holds the value exactly
as the parser will read it.

The records are written as the slot text the port's native parser reads
(``1 <label> [<dense_dim> <v>...] 1 <key> ...``), built as one byte
matrix a pass with fixed-width fields: keys are zero-padded to seven
digits and the values to ``d.dddd``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

KEY_DIGITS = 7  # keys lie in [1, 2**22): seven decimal digits
DENSE_SCALE = 10_000  # dense values are multiples of 1e-4 below 10


@dataclass
class PassData:
    keys: np.ndarray  # uint64 [n, num_slots], one key a slot
    labels: np.ndarray  # float32 [n], 0 or 1
    dense: Optional[np.ndarray]  # float32 [n, dense_dim] or None


def make_pass(rng: np.random.Generator, n: int, num_slots: int, dense_dim: int, key_space: int,
              mix: dict) -> PassData:
    """``n`` records of ``num_slots`` one-key slots from ``rng``."""
    shape = (n, num_slots)
    if key_space >= 10**KEY_DIGITS:
        raise ValueError(f"key_space {key_space} needs more than {KEY_DIGITS} digits")
    hot = rng.integers(1, mix["hot_keys"], shape, dtype=np.int64)
    cold = rng.integers(1, key_space, shape, dtype=np.int64)
    take_hot = rng.random(shape) < mix["hot_frac"]
    keys = np.where(take_hot, hot, cold).astype(np.uint64)
    labels = (rng.random(n) < mix["pos_frac"]).astype(np.float32)
    dense = None
    if dense_dim:
        q = np.rint(np.log1p(rng.exponential(8.0, (n, dense_dim))) * DENSE_SCALE).astype(np.int64)
        if q.max() >= 10 * DENSE_SCALE:
            raise ValueError("a dense value does not fit d.dddd")
        dense = (q / DENSE_SCALE).astype(np.float32)
    return PassData(keys=keys, labels=labels, dense=dense)


def distinct(keys: np.ndarray, key_space: int) -> np.ndarray:
    """The sorted distinct keys of ``keys`` (all below ``key_space``)."""
    seen = np.zeros(key_space, dtype=bool)
    seen[keys.reshape(-1)] = True
    return np.flatnonzero(seen).astype(np.uint64)


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """ASCII digits of non-negative ints below 2**31, zero-padded: uint8
    [..., width]."""
    out = np.empty(values.shape + (width,), dtype=np.uint8)
    v = values.astype(np.int32)
    for p in range(width - 1, -1, -1):
        v, d = np.divmod(v, 10)
        out[..., p] = d
    out += 48
    return out


def pass_text(data: PassData) -> np.ndarray:
    """The pass as slot text, uint8 [n, line_bytes], every line ending in a
    newline."""
    n, S = data.keys.shape
    parts = []
    lab = np.empty((n, 6), dtype=np.uint8)  # "1 0.0 " / "1 1.0 "
    lab[:] = np.frombuffer(b"1 0.0 ", dtype=np.uint8)
    lab[:, 2] = 48 + data.labels.astype(np.int64)
    parts.append(lab)
    if data.dense is not None:
        Dd = data.dense.shape[1]
        head = np.frombuffer(f"{Dd} ".encode(), dtype=np.uint8)
        parts.append(np.broadcast_to(head, (n, len(head))))
        q = np.rint(data.dense.astype(np.float64) * DENSE_SCALE).astype(np.int64)
        d = _digits(q, 5)  # [n, Dd, 5] -> "d.dddd "
        f = np.empty((n, Dd, 7), dtype=np.uint8)
        f[..., 0] = d[..., 0]
        f[..., 1] = ord(".")
        f[..., 2:6] = d[..., 1:]
        f[..., 6] = ord(" ")
        parts.append(f.reshape(n, -1))
    k = np.empty((n, S, KEY_DIGITS + 3), dtype=np.uint8)  # "1 ddddddd "
    k[..., 0] = ord("1")
    k[..., 1] = ord(" ")
    k[..., 2 : 2 + KEY_DIGITS] = _digits(data.keys, KEY_DIGITS)
    k[..., -1] = ord(" ")
    k[:, -1, -1] = ord("\n")
    parts.append(k.reshape(n, -1))
    return np.concatenate(parts, axis=1)


def write_pass(directory: str, tag: str, data: PassData, n_files: int) -> List[str]:
    """Write the pass as ``n_files`` part files of consecutive records, in
    record order; returns their paths."""
    text = pass_text(data)
    paths = []
    for i, block in enumerate(np.array_split(text, n_files)):
        path = os.path.join(directory, f"{tag}-{i:03d}.txt")
        with open(path, "wb") as f:
            f.write(block.tobytes())
        paths.append(path)
    return paths
