"""File writing: crash-safe local publishing and the write tier.

Port of ``atomic_write``, ``fs_open_write`` and its shell pipe from the
JAX package's ``utils/fs.py``. The checkpoint chain and the dense files
write through ``atomic_write`` (local only); the dump writers through
``fs_open_write``, which dispatches on the path (fs_open_write,
framework/io/fs.cc): a local path gets a plain or gzip stream, a remote
one (``hdfs:``/``afs:``) a popen'd ``hadoop fs -put -`` pipe, and an
optional converter command is spliced into the pipe either way. The read
tier and the file manager are not ported.
"""

from __future__ import annotations

import gzip
import os
import subprocess
from contextlib import contextmanager
from typing import Optional

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire

config.define_flag("hadoop_bin", "hadoop", "hadoop client binary for hdfs:/afs: paths")

_REMOTE_PREFIXES = ("hdfs:", "afs:")


def is_remote(path: str) -> bool:
    return path.startswith(_REMOTE_PREFIXES)


class _PipeStream:
    """A writable text stream into a shell pipeline; raises on a nonzero
    exit at close (the shell pipe's error propagation,
    framework/io/shell.cc)."""

    def __init__(self, cmd: str):
        self.cmd = cmd
        self.proc = subprocess.Popen(cmd, shell=True, stdin=subprocess.PIPE, text=True)
        self.stream = self.proc.stdin

    def write(self, s: str) -> int:
        return self.stream.write(s)

    def close(self) -> None:
        try:
            self.stream.close()  # flushes what is still buffered
        except BrokenPipeError:
            # the pipeline exited before it read all of its input: a failure
            # whatever its exit status, reported as the others are
            self.proc.wait()
            raise RuntimeError(
                f"pipe command failed ({self.proc.returncode}) before reading its input: {self.cmd}"
            ) from None
        if self.proc.wait() != 0:
            raise RuntimeError(f"pipe command failed ({self.proc.returncode}): {self.cmd}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:  # the error path: do not mask the original exception
            self.proc.kill()
            self.proc.wait()


def fs_open_write(path: str, converter: Optional[str] = None):
    """A writable text stream. A remote path goes through ``hadoop fs -put
    -`` (that branch is ported as the JAX package has it and has no test
    here: no hadoop client exists where the tests run); a local path's
    parent directories are created first. ``converter`` is a shell command
    the text is piped through before it lands (``converter > path``
    locally). A ``.gz`` local path without a converter is gzipped. The
    fault site ``fs.open_write`` fires before anything opens."""
    _fault_fire("fs.open_write")
    if is_remote(path):
        cmd = f"{config.get_flag('hadoop_bin')} fs -put - '{path}'"
        if converter:
            cmd = f"{converter} | " + cmd
        return _PipeStream(cmd)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if converter:
        return _PipeStream(f"{converter} > '{path}'")
    if path.endswith(".gz"):
        return gzip.open(path, "wt")
    return open(path, "w")


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
