"""The multi-hot traffic: records whose slots hold a fixed number of keys
each, every slot drawing from its own key range.

A configuration names each slot's key count (``multi_hot_sizes``) and its
table's cardinality; slot s ranges over ``min(cardinality, key_space)``
keys, the keys after slot s - 1's (so no two slots share a key), from 1.
A key is drawn from the slot's hot head of ``min(hot_keys, range)`` keys
``hot_frac`` of the time, else uniform over the slot's range; a label is 1
with probability ``pos_frac``, drawn apart from the keys; the dense slot
holds ``log1p`` of exponential counts (mean 8) to four decimals, as
``core/traffic.py`` draws them.

The slot text the port's native parser reads: ``1 <label> <dense_dim>
<v>... <n> <k1> ... <kn> ...``, keys zero-padded to eight digits; every
slot's count is fixed, so a pass is one byte matrix of fixed-width lines.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from bench_port.core.traffic import DENSE_SCALE, PassData, _digits

KEY_DIGITS = 8  # keys lie in [1, 10^8)


def ranges(cfg: dict) -> np.ndarray:
    """Each slot's key count, int64 [S]."""
    return np.minimum(np.asarray(cfg["cardinalities"], np.int64), cfg["key_space"])


def key_space(cfg: dict) -> int:
    """One past the largest key: every key lies in [1, key_space)."""
    return 1 + int(ranges(cfg).sum())


def make_pass(rng: np.random.Generator, n: int, cfg: dict, mix: dict) -> PassData:
    """``n`` records from ``rng``: keys uint64 [n, K], columns in slot
    order, ``multi_hot_sizes[s]`` of them slot s's."""
    sizes = cfg["multi_hot_sizes"]
    if len(sizes) != cfg["num_slots"] or len(cfg["cardinalities"]) != cfg["num_slots"]:
        raise ValueError("a configuration needs a key count and a cardinality a slot")
    if key_space(cfg) > 10**KEY_DIGITS:
        raise ValueError(f"{key_space(cfg) - 1} keys need more than {KEY_DIGITS} digits")
    r = ranges(cfg)
    first = 1 + np.concatenate([[0], np.cumsum(r)[:-1]])  # slot s's first key
    col_range, col_first = np.repeat(r, sizes), np.repeat(first, sizes)
    shape = (n, len(col_range))
    hot = rng.integers(0, np.minimum(mix["hot_keys"], col_range), shape)
    cold = rng.integers(0, col_range, shape)
    take_hot = rng.random(shape) < mix["hot_frac"]
    keys = (col_first + np.where(take_hot, hot, cold)).astype(np.uint64)
    labels = (rng.random(n) < mix["pos_frac"]).astype(np.float32)
    q = np.rint(np.log1p(rng.exponential(8.0, (n, cfg["dense_dim"]))) * DENSE_SCALE).astype(np.int64)
    if q.max() >= 10 * DENSE_SCALE:
        raise ValueError("a dense value does not fit d.dddd")
    return PassData(keys=keys, labels=labels, dense=(q / DENSE_SCALE).astype(np.float32))


def pass_text(data: PassData, sizes: List[int]) -> np.ndarray:
    """The pass as slot text, uint8 [n, line_bytes], every line ending in a
    newline."""
    n, Dd = data.dense.shape
    lab = np.empty((n, 6), dtype=np.uint8)  # "1 0.0 " / "1 1.0 "
    lab[:] = np.frombuffer(b"1 0.0 ", dtype=np.uint8)
    lab[:, 2] = 48 + data.labels.astype(np.int64)
    parts = [lab, np.broadcast_to(np.frombuffer(f"{Dd} ".encode(), dtype=np.uint8), (n, len(f"{Dd} ")))]
    d = _digits(np.rint(data.dense.astype(np.float64) * DENSE_SCALE).astype(np.int64), 5)  # "d.dddd "
    f = np.empty((n, Dd, 7), dtype=np.uint8)
    f[..., 0] = d[..., 0]
    f[..., 1] = ord(".")
    f[..., 2:6] = d[..., 1:]
    f[..., 6] = ord(" ")
    parts.append(f.reshape(n, -1))
    k = np.empty((n, data.keys.shape[1], KEY_DIGITS + 1), dtype=np.uint8)  # "dddddddd "
    k[..., :KEY_DIGITS] = _digits(data.keys, KEY_DIGITS)
    k[..., KEY_DIGITS] = ord(" ")
    c = 0
    for size in sizes:
        head = f"{size} ".encode()
        parts.append(np.broadcast_to(np.frombuffer(head, dtype=np.uint8), (n, len(head))))
        parts.append(k[:, c : c + size].reshape(n, -1))
        c += size
    text = np.concatenate(parts, axis=1)
    text[:, -1] = ord("\n")
    return text


def write_pass(directory: str, tag: str, data: PassData, sizes: List[int], n_files: int) -> List[str]:
    """Write the pass as ``n_files`` part files of consecutive records, in
    record order; returns their paths."""
    text = pass_text(data, sizes)
    paths = []
    for i, block in enumerate(np.array_split(text, n_files)):
        path = os.path.join(directory, f"{tag}-{i:03d}.txt")
        with open(path, "wb") as fh:
            fh.write(block.tobytes())
        paths.append(path)
    return paths
