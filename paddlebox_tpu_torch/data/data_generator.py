"""User-side data generators for pipe_command preprocessing.

Port of the JAX package's ``data/data_generator.py``; the text it writes
is byte-identical to that package's for the same samples.

Parity with ``paddle.fluid.incubate.data_generator`` (incubate/
data_generator/__init__.py:21-340): a user subclass defines
``generate_sample(line)`` returning an iterator of
``[(slot_name, [values...]), ...]`` samples (and optionally
``generate_batch(samples)``); ``run_from_stdin`` turns raw lines from stdin
into the slot text protocol on stdout —

    <num> <v0> <v1> ...   per slot, schema order

which is exactly what ``parse_line`` / BoxPSDataset's pipe_command path
consumes. The generator script *is* the pipe_command:

    pipe_command="python my_gen.py"  ->  reader | my_gen.py | parser

Slot order/type consistency across lines is enforced like the reference's
running ``proto_info`` check; empty value lists are rejected (the feed
requires a nonzero count — pad in the generator).
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

Sample = Sequence[Tuple[str, Sequence[Any]]]


def _is_float(e) -> bool:
    """float-typed value (incl. numpy floating scalars; ints stay uint64)."""
    import numpy as np

    return isinstance(e, (float, np.floating))


class DataGenerator:
    """Base class: override ``generate_sample`` (and maybe ``generate_batch``)."""

    def __init__(self):
        self._proto_info: Optional[List[Tuple[str, str]]] = None
        self.batch_size_ = 32

    # ---- user hooks ------------------------------------------------------

    def generate_sample(self, line: Optional[str]):
        """Return an iterator factory over parsed samples for one raw line
        (None for run_from_memory)."""
        raise NotImplementedError(
            "implement generate_sample(line) -> callable yielding "
            "[(slot_name, [values...]), ...]"
        )

    def generate_batch(self, samples: List[Sample]):
        """Optional batch-level hook; default passes samples through."""

        def local_iter():
            for s in samples:
                yield s

        return local_iter

    def set_batch(self, batch_size: int) -> None:
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.batch_size_ = batch_size

    # ---- drivers ---------------------------------------------------------

    def run_from_stdin(self, stdin=None, stdout=None) -> int:
        """Read raw lines, emit slot-protocol lines. Returns lines written."""
        fin = stdin if stdin is not None else sys.stdin
        fout = stdout if stdout is not None else sys.stdout
        n = 0
        batch: List[Sample] = []
        for line in fin:
            it = self.generate_sample(line)
            for sample in it():
                if sample is None:
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size_:
                    n += self._flush(batch, fout)
                    batch = []
        if batch:
            n += self._flush(batch, fout)
        return n

    def run_from_memory(self, stdout=None) -> int:
        """Generate without input lines (debug/bench parity)."""
        fout = stdout if stdout is not None else sys.stdout
        batch: List[Sample] = []
        n = 0
        for sample in self.generate_sample(None)():
            if sample is None:
                continue
            batch.append(sample)
            if len(batch) == self.batch_size_:
                n += self._flush(batch, fout)
                batch = []
        if batch:
            n += self._flush(batch, fout)
        return n

    def _flush(self, batch: List[Sample], fout) -> int:
        n = 0
        for sample in self.generate_batch(batch)():
            fout.write(self._gen_str(sample))
            n += 1
        return n

    def _gen_str(self, sample: Sample) -> str:
        raise NotImplementedError


class MultiSlotDataGenerator(DataGenerator):
    """Emits the `num v...` text protocol with slot-consistency checking."""

    def _gen_str(self, sample: Sample) -> str:
        if not isinstance(sample, (list, tuple)):
            raise ValueError(
                "a sample must be [(slot_name, [values...]), ...], got "
                f"{type(sample).__name__}"
            )
        # first sample fixes the slot order + types (proto_info parity)
        if self._proto_info is None:
            self._proto_info = []
            for name, elements in sample:
                if not elements:
                    raise ValueError(
                        f"slot {name!r} has no values — the feed needs a "
                        "nonzero count; pad in the generator"
                    )
                t = (
                    "float"
                    if any(_is_float(e) for e in elements)
                    else "uint64"
                )
                self._proto_info.append((name, t))
        else:
            if len(sample) != len(self._proto_info):
                raise ValueError(
                    f"sample has {len(sample)} slots, previous lines had "
                    f"{len(self._proto_info)}"
                )
        parts = []
        for (name, elements), (pname, ptype) in zip(sample, self._proto_info):
            if name != pname:
                raise ValueError(
                    f"slot order changed: got {name!r}, expected {pname!r}"
                )
            if not elements:
                raise ValueError(f"slot {name!r} has no values")
            is_float = any(_is_float(e) for e in elements)
            if is_float and ptype == "uint64":
                raise ValueError(
                    f"slot {name!r} switched from uint64 to float mid-stream"
                )
            parts.append(str(len(elements)))
            # repr keeps full float precision (the reference emits str(e))
            parts.extend(
                (repr(float(e)) if ptype == "float" else str(int(e)))
                for e in elements
            )
        return " ".join(parts) + "\n"
