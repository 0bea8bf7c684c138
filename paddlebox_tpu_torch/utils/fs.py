"""Filesystem dispatch: local files and remote stores behind shell pipes.

Port of the JAX package's ``utils/fs.py`` (the reference's open tier,
framework/io/fs.{h,cc}, and its file manager, box_wrapper.h:778-802):

- ``fs_open_read`` / ``fs_open_write`` dispatch on the path: a local path
  gets a plain or gzip stream, a remote one (``hdfs:``/``afs:``) a popen'd
  ``hadoop fs -cat`` / ``-put -`` pipe through the ``hadoop_bin`` binary,
  and an optional converter command (a dataset's ``pipe_command``) is
  spliced into the pipe either way;
- the ``*_retry`` forms reopen a file that is transiently missing with a
  linear backoff (flags ``fs_open_retries``, ``fs_open_backoff_s``;
  data_feed.cc:2738-2740), counted in ``fs_open_retries_total``;
- ``atomic_write`` publishes a local file crash-safely (the checkpoint
  chain, the dense files, the stream cursor);
- ``fs_exists`` / ``fs_mkdir`` / ``fs_remove`` / ``fs_glob`` and
  ``FileMgr`` are the ls/mkdir/exists/upload/download/remove tier.

Fault sites: ``fs.open_read`` (before a read opens), ``fs.open_write``
and ``fs.atomic_write``.
"""

from __future__ import annotations

import glob as _glob
import gzip
import os
import shutil
import subprocess
import time
from contextlib import contextmanager
from typing import IO, Iterator, List, Optional

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire
from paddlebox_tpu_torch.utils.monitor import STAT_ADD

config.define_flag("hadoop_bin", "hadoop", "hadoop client binary for hdfs:/afs: paths")
config.define_flag("hdfs_retry", 3, "retry count for remote fs commands")
config.define_flag("fs_open_retries", 3, "retry-until-open attempts for data files")
config.define_flag(
    "fs_open_backoff_s",
    1.0,
    "base linear backoff (seconds) between retry-until-open attempts; "
    "tests and chaos schedules turn it down to keep injected flakes cheap",
)

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


class _PipeReadStream:
    """A readable text stream out of a shell pipeline, optionally fed a
    file on its stdin; raises on a nonzero exit at close. A reader that
    stops before the end kills the pipeline rather than wait on a child
    blocked writing into a pipe nobody reads."""

    def __init__(self, cmd: str, stdin_file: Optional[IO] = None):
        self.cmd = cmd
        self.proc = subprocess.Popen(cmd, shell=True, stdin=stdin_file, stdout=subprocess.PIPE, text=True)
        self.stream = self.proc.stdout
        self._eof = False

    def __iter__(self) -> Iterator[str]:
        for line in self.stream:
            yield line
        self._eof = True

    def read(self, *a) -> str:
        out = self.stream.read(*a)
        if not out or not a or a[0] is None or a[0] < 0:
            self._eof = True
        return out

    def close(self) -> None:
        if not self._eof:
            # an early close: the child may still be writing
            self.proc.kill()
            self.stream.close()
            self.proc.wait()
            return
        self.stream.close()
        if self.proc.wait() != 0:
            raise RuntimeError(f"pipe command failed ({self.proc.returncode}): {self.cmd}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:  # the error path: do not mask the original exception
            self.proc.kill()
            self.stream.close()
            self.proc.wait()


def _hadoop_cmd() -> str:
    return f"{config.get_flag('hadoop_bin')} fs"


def _retry_open(fn, retries: Optional[int], backoff_s: Optional[float]):
    """The retry-until-open policy: an OSError sleeps a linear backoff and
    retries; the last error raises after ``fs_open_retries`` attempts."""
    n = max(1, retries if retries is not None else int(config.get_flag("fs_open_retries")))
    if backoff_s is None:
        backoff_s = float(config.get_flag("fs_open_backoff_s"))
    last: Optional[BaseException] = None
    for attempt in range(n):
        try:
            return fn()
        except OSError as e:
            last = e
            if attempt + 1 < n:
                STAT_ADD("fs_open_retries_total")
                time.sleep(backoff_s * (attempt + 1))
    raise last


def fs_open_read(path: str, converter: Optional[str] = None):
    """A readable text stream for ``path`` (fs_open_read, io/fs.h:36-88).
    A remote path streams through ``hadoop fs -cat``; ``.gz`` decompresses
    (``zcat`` inside a pipe); ``converter``, a shell command reading its
    stdin, is spliced last, where the reference puts pipe converters. The
    fault site ``fs.open_read`` fires before anything opens."""
    _fault_fire("fs.open_read")
    if is_remote(path):
        cmd = f"{_hadoop_cmd()} -cat '{path}'"
        if path.endswith(".gz"):
            cmd += " | zcat"
        if converter:
            cmd += f" | {converter}"
        return _PipeReadStream(cmd)
    if converter:
        cmd = f"zcat | {converter}" if path.endswith(".gz") else converter
        with open(path, "rb") as src:  # the child holds its own descriptor
            return _PipeReadStream(cmd, stdin_file=src)
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def fs_open_read_retry(
    path: str,
    converter: Optional[str] = None,
    retries: Optional[int] = None,
    backoff_s: Optional[float] = None,
):
    """``fs_open_read`` with retry-until-open: a file that is not there
    yet (a part file still being published) is reopened with a linear
    backoff. A remote path is probed first (a hadoop pipe opens lazily, so
    the flake would surface mid-stream, where a retry could duplicate
    lines); a probe that fails for another reason than a missing path (no
    client, no cluster) raises at once."""

    def attempt():
        if is_remote(path):
            try:
                _run_remote(f"-test -e '{path}' && echo yes")
            except RuntimeError as e:
                if getattr(e.__cause__, "returncode", None) == 1:
                    raise OSError(f"remote path not available yet: {path}") from e
                raise RuntimeError(
                    f"remote fs probe failed for {path!r} (hadoop client error, not a missing file)"
                ) from e
        return fs_open_read(path, converter)

    return _retry_open(attempt, retries, backoff_s)


def fs_read_bytes_retry(path: str, retries: Optional[int] = None, backoff_s: Optional[float] = None) -> bytes:
    """A local plain file's bytes with retry-until-open (the native
    parser's one-shot read); remote and ``.gz`` paths go through the line
    reader instead."""
    if is_remote(path) or path.endswith(".gz"):
        raise ValueError(
            f"fs_read_bytes_retry is local-plain-file only, got {path!r} (use fs_open_read_retry for remote/gz)"
        )

    def attempt():
        _fault_fire("fs.open_read")
        with open(path, "rb") as f:
            return f.read()

    return _retry_open(attempt, retries, backoff_s)


def fs_open_write_retry(
    path: str,
    converter: Optional[str] = None,
    retries: Optional[int] = None,
    backoff_s: Optional[float] = None,
):
    """``fs_open_write`` with retry-until-open. Only the open retries: a
    failure mid-stream raises, since rewriting a partly flushed stream
    could duplicate data."""
    return _retry_open(lambda: fs_open_write(path, converter), retries, backoff_s)


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
        cmd = f"{_hadoop_cmd()} -put - '{path}'"
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
    return open(path, "w")  # pbox-lint: disable=IO004  (the wrapper itself)


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


def _run_remote(args: str) -> str:
    last: Optional[Exception] = None
    for _ in range(max(1, int(config.get_flag("hdfs_retry")))):
        try:
            return subprocess.check_output(
                f"{_hadoop_cmd()} {args}", shell=True, text=True, stderr=subprocess.DEVNULL
            )
        except subprocess.CalledProcessError as e:  # retried, then raised below
            last = e
    raise RuntimeError(f"remote fs command failed: {args}") from last


def fs_exists(path: str) -> bool:
    if is_remote(path):
        try:
            _run_remote(f"-test -e '{path}' && echo yes")
            return True
        except RuntimeError:
            return False
    return os.path.exists(path)


def fs_mkdir(path: str) -> None:
    if is_remote(path):
        _run_remote(f"-mkdir -p '{path}'")
    else:
        os.makedirs(path, exist_ok=True)


def fs_remove(path: str) -> None:
    if is_remote(path):
        _run_remote(f"-rm -r '{path}'")
    elif os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def fs_glob(pattern: str) -> List[str]:
    """The files matching ``pattern``, sorted locally; a remote pattern
    lists through ``hadoop fs -ls``."""
    if is_remote(pattern):
        files = []
        for line in _run_remote(f"-ls '{pattern}'").splitlines():
            parts = line.split()
            if len(parts) >= 8 and not parts[0].startswith("Found"):
                files.append(parts[-1])
        return files
    return sorted(_glob.glob(pattern))


class FileMgr:
    """The open ``BoxFileMgr`` (box_wrapper.h:778-802): ls, mkdir, exists,
    upload, download, remove and touch over the dispatch above."""

    def ls(self, path: str) -> List[str]:
        pattern = path if any(c in path for c in "*?[") else os.path.join(path, "*")
        return fs_glob(pattern)

    def exists(self, path: str) -> bool:
        return fs_exists(path)

    def mkdir(self, path: str) -> None:
        fs_mkdir(path)

    def remove(self, path: str) -> None:
        fs_remove(path)

    def touch(self, path: str) -> None:
        with fs_open_write(path) as f:
            f.write("")

    def download(self, remote: str, local: str) -> None:
        with fs_open_read(remote) as src, fs_open_write(local) as dst:
            shutil.copyfileobj(src, dst)

    def upload(self, local: str, remote: str) -> None:
        with fs_open_read(local) as src, fs_open_write(remote) as dst:
            shutil.copyfileobj(src, dst)
