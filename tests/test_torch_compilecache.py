"""The port's compile cache (``paddlebox_tpu_torch/utils/compilecache.py``)
against the JAX package's, and its wiring into the kernel build.

``resolve_dir`` and the flag's default agree with the JAX package's on
every case of a table. The build is driven through
``cuda_kernels._build`` with a stub ``nvcc`` on ``PATH`` (a script that
logs each call, answers ``--version`` from a file and writes its ``-o``
target), so no card and no toolkit is needed; ``load_library`` would load
the stub's bytes, so it is not called. The cache is process-global: every
test here starts and ends with it disabled."""

from __future__ import annotations

import os
import shutil
import stat
import threading

import pytest
import torch

import paddlebox_tpu.config as jconfig
import paddlebox_tpu_torch.config as tconfig
from paddlebox_tpu.utils import compilecache as jcompilecache
from paddlebox_tpu_torch.ops import cuda_kernels as ck
from paddlebox_tpu_torch.utils import compilecache
from tests.test_torch_supervisor import _sup

torch.set_num_threads(2)

GATHER, WRITE = "gather_rows.cu", "write_rows.cu"

STUB_NVCC = """#!/bin/sh
here=$(dirname "$0")
if [ "$1" = "--version" ]; then
    echo version >> "$here/calls.log"
    cat "$here/version.txt"
    exit 0
fi
out=""
prev=""
for a in "$@"; do
    if [ "$prev" = "-o" ]; then out="$a"; fi
    prev="$a"
done
echo "build $out" >> "$here/calls.log"
sleep "$(cat "$here/delay.txt")"
echo "stub library of $*" > "$out"
echo "ptxas info    : Used 25 registers, used 1 barriers" >&2
"""


@pytest.fixture(autouse=True)
def _isolated():
    compilecache.disable()
    yield
    compilecache.disable()


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """A stub nvcc first on PATH, a copy of the kernel sources, an empty
    ``_build/`` and a fresh toolkit memo (as a new process has)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    (bin_dir / "version.txt").write_text("Cuda compilation tools, release 12.8, V12.8.93\n")
    (bin_dir / "delay.txt").write_text("0\n")
    (bin_dir / "calls.log").write_text("")
    csrc = tmp_path / "csrc"
    shutil.copytree(ck._CSRC, csrc)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setattr(ck, "_CSRC", str(csrc))
    monkeypatch.setattr(ck, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(ck, "_toolkit_ids", {})

    def calls(kind="build"):
        lines = (bin_dir / "calls.log").read_text().splitlines()
        return [line for line in lines if line.split()[0] == kind]

    return type("Stub", (), {"bin": bin_dir, "csrc": csrc, "calls": staticmethod(calls)})


def _delta(before):
    now = compilecache.stats()
    return {k: now[k] - before[k] for k in ("hits", "misses", "requests")}


@pytest.mark.parametrize(
    "flag,root",
    [
        ("auto", None), ("auto", "/ckpt/base"), ("auto", ""), ("off", "/ckpt/base"), ("", "/ckpt/base"),
        ("none", None), ("  off  ", None), (" auto ", "/r"), ("/explicit/cc", None), ("/explicit/cc", "/r"),
        ("relative/cc", "/r"), (None, "/r"),
    ],
)
def test_resolve_dir_matches_the_jax_package(flag, root):
    assert compilecache.resolve_dir(flag, ckpt_root=root) == jcompilecache.resolve_dir(flag, ckpt_root=root)


def test_flag_default_matches_the_jax_package():
    assert tconfig._defs["compile_cache_dir"][1] == jconfig._defs["compile_cache_dir"][1] == "auto"


def test_cold_miss_builds_once_and_warm_request_hits(stub, tmp_path):
    cache = compilecache.enable(str(tmp_path / "cc"))
    assert compilecache.enabled_dir() == cache
    before = compilecache.stats()
    lib, report = ck._build(GATHER)
    assert os.path.dirname(lib) == cache and os.path.exists(lib)
    assert "ptxas info" in report
    assert len(stub.calls()) == 1
    assert [n for n, _ in ck.nvcc_runs()][-1:] == [GATHER]
    assert _delta(before) == {"hits": 0, "misses": 1, "requests": 1}
    assert not os.path.exists(ck.BUILD_DIR)  # the cache's build leaves _build/ alone
    lib2, report2 = ck._build(GATHER)
    assert (lib2, report2) == (lib, "")
    assert len(stub.calls()) == 1
    assert _delta(before) == {"hits": 1, "misses": 1, "requests": 2}
    assert len(stub.calls("version")) == 1  # read once a process


def test_an_edited_header_misses(stub, tmp_path):
    compilecache.enable(str(tmp_path / "cc"))
    lib, _ = ck._build(WRITE)
    header = next(n for n in sorted(os.listdir(stub.csrc)) if n.endswith(".cuh"))
    with open(stub.csrc / header, "a") as f:
        f.write("// edited\n")
    before = compilecache.stats()
    lib2, _ = ck._build(WRITE)
    assert lib2 != lib and os.path.exists(lib) and os.path.exists(lib2)
    assert len(stub.calls()) == 2
    assert _delta(before) == {"hits": 0, "misses": 1, "requests": 1}


def test_another_toolkit_misses(stub, tmp_path, monkeypatch):
    compilecache.enable(str(tmp_path / "cc"))
    lib, _ = ck._build(GATHER)
    (stub.bin / "version.txt").write_text("Cuda compilation tools, release 12.9, V12.9.41\n")
    before = compilecache.stats()
    assert ck._build(GATHER)[0] == lib  # this process read its toolkit once
    monkeypatch.setattr(ck, "_toolkit_ids", {})  # a new process reads it anew
    lib2, _ = ck._build(GATHER)
    assert lib2 != lib
    assert len(stub.calls()) == 2
    assert _delta(before) == {"hits": 1, "misses": 1, "requests": 2}


def test_a_key_in_the_package_build_fills_the_cache_without_nvcc(stub, tmp_path):
    local, report = ck._build(GATHER)  # no cache: the package's _build/
    assert os.path.dirname(local) == ck.BUILD_DIR and "ptxas info" in report
    assert len(stub.calls()) == 1
    cache = compilecache.enable(str(tmp_path / "cc"))
    before = compilecache.stats()
    lib, report = ck._build(GATHER)
    assert os.path.dirname(lib) == cache and os.path.basename(lib) == os.path.basename(local)
    assert report == "" and len(stub.calls()) == 1
    with open(lib, "rb") as a, open(local, "rb") as b:
        assert a.read() == b.read()
    assert _delta(before) == {"hits": 0, "misses": 1, "requests": 1}
    assert ck._build(GATHER) == (lib, "")
    assert _delta(before) == {"hits": 1, "misses": 1, "requests": 2}


@pytest.mark.parametrize("cached", [True, False], ids=["cache", "package_build"])
def test_two_threads_on_one_key_run_one_build(stub, tmp_path, cached):
    (stub.bin / "delay.txt").write_text("0.5\n")
    if cached:
        compilecache.enable(str(tmp_path / "cc"))
    before = compilecache.stats()
    out = [None, None]

    def build(i):
        out[i] = ck._build(WRITE)

    threads = [threading.Thread(target=build, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out[0][0] == out[1][0] and os.path.exists(out[0][0])
    assert sorted(bool(report) for _, report in out) == [False, True]
    assert len(stub.calls()) == 1
    want = {"hits": 0, "misses": 2, "requests": 2} if cached else {"hits": 0, "misses": 0, "requests": 0}
    assert _delta(before) == want


def test_disable_returns_the_build_to_the_package(stub, tmp_path):
    compilecache.enable(str(tmp_path / "cc"))
    assert os.path.dirname(ck._build(GATHER)[0]) == str(tmp_path / "cc")
    compilecache.disable()
    assert compilecache.enabled_dir() is None
    before = compilecache.stats()
    lib, _ = ck._build(GATHER)
    assert os.path.dirname(lib) == ck.BUILD_DIR
    assert len(stub.calls()) == 2
    assert _delta(before) == {"hits": 0, "misses": 0, "requests": 0}


def test_stats_counts_and_entries(stub, tmp_path):
    assert compilecache.stats()["enabled"] is False and compilecache.stats()["entries"] == 0
    cache = compilecache.enable(str(tmp_path / "cc"))
    before = compilecache.stats()
    assert before["enabled"] and before["dir"] == cache and before["entries"] == 0
    for source in (GATHER, WRITE, GATHER, WRITE, WRITE):
        ck._build(source)
    s = compilecache.stats()
    assert set(s) == {"enabled", "dir", "hits", "misses", "requests", "entries"}
    assert set(s) == set(jcompilecache.stats())
    assert _delta(before) == {"hits": 3, "misses": 2, "requests": 5}
    assert s["entries"] == 2  # the lock files are not entries
    names = [ck.library_name(source) for source in (GATHER, WRITE)]
    assert sorted(os.listdir(cache)) == sorted(names + [n + ".lock" for n in names])
    shutil.rmtree(cache)
    assert compilecache.stats()["entries"] == -1


def test_both_supervisors_enable_the_cache_under_their_checkpoint_root(tmp_path):
    """Under "auto" a supervisor with a checkpoint resolves the cache to
    ``<root>/compile_cache`` and enables it, in both packages."""
    assert tconfig.get_flag("compile_cache_dir") == jconfig.get_flag("compile_cache_dir") == "auto"
    for pkg, cc in (("torch", compilecache), ("jax", jcompilecache)):
        cc.disable()
        st = _sup(pkg, tmp_path, "cc")
        want = os.path.join(os.path.abspath(st.cm.root), "compile_cache")
        assert cc.enabled_dir() == want and os.path.isdir(want)
        cc.disable()
