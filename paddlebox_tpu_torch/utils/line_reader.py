"""Line readers over fs streams.

Parity with ``LineFileReader`` (string/string_helper.h:146) and
``BufferedLineFileReader`` (data_feed.cc:57): the buffered variant applies a
line sampling rate — the reference's down-sampling knob for debug/fast runs —
and tracks line counts for stage stats.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.utils.fs import fs_open_read_retry


class LineFileReader:
    """Iterate stripped lines of one file (local/remote/gz/converter)."""

    def __init__(self, path: str, converter: Optional[str] = None):
        self.path = path
        self.converter = converter
        self.lines_read = 0

    def __iter__(self) -> Iterator[str]:
        stream = fs_open_read_retry(self.path, self.converter)
        try:
            for line in stream:
                self.lines_read += 1
                yield line.rstrip("\n")
        finally:
            close = getattr(stream, "close", None)
            if close:
                close()


class BufferedLineFileReader:
    """LineFileReader + uniform line sampling (data_feed.cc:57 parity).

    ``sample_rate`` < 1 keeps each line with that probability using a
    per-reader RNG (deterministic given ``seed``), so multi-threaded readers
    stay reproducible.
    """

    def __init__(
        self,
        path: str,
        converter: Optional[str] = None,
        sample_rate: Optional[float] = None,
        seed: int = 0,
    ):
        self.inner = LineFileReader(path, converter)
        self.sample_rate = (
            sample_rate if sample_rate is not None else config.get_flag("sample_rate")
        )
        self._rng = np.random.default_rng(seed)
        self.lines_kept = 0

    @property
    def lines_read(self) -> int:
        return self.inner.lines_read

    def __iter__(self) -> Iterator[str]:
        rate = self.sample_rate
        if rate >= 1.0:
            for line in self.inner:
                self.lines_kept += 1
                yield line
            return
        for line in self.inner:
            if self._rng.random() < rate:
                self.lines_kept += 1
                yield line
