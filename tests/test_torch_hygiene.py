"""The port stands alone: it imports neither ``jax`` nor ``paddlebox_tpu``,
and its entry points refuse to fall back to the CPU quietly."""

import os
import re
import subprocess
import sys

import pytest
import torch

from paddlebox_tpu_torch.serve import Scorer
from paddlebox_tpu_torch.table import ValueLayout
from paddlebox_tpu_torch.train import CTRTrainer, TrainStepConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
had_jax = "jax" in sys.modules
import paddlebox_tpu_torch
walked = [m.name for m in pkgutil.walk_packages(paddlebox_tpu_torch.__path__, "paddlebox_tpu_torch.")]
for name in walked:
    importlib.import_module(name)
print("WALKED=" + ",".join(walked))
new = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "paddlebox_tpu"))
print("NEW=" + ("" if had_jax else ",".join(new)))
print("PBT=" + ",".join(n for n in new if n.split(".")[0] == "paddlebox_tpu"))
"""


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    out = dict(line.split("=", 1) for line in r.stdout.splitlines() if "=" in line)
    assert out["NEW"] == "", out
    assert out["PBT"] == "", out
    walked = set(out["WALKED"].split(","))
    for m in ("train.checkpoint", "train.rollback", "serve.follower", "utils.fs",
              "ops.wire_quant", "table.carrier", "data.pv_instance", "ops.ctr_ops",
              "models.rank", "metrics.registry", "models.lr", "models.wide_deep", "models.mmoe",
              "train.async_dense", "utils.dump", "boxps", "parallel", "parallel.mesh",
              "parallel.sharded_pullpush", "fleet", "fleet.role_maker", "fleet.strategy", "fleet.zero",
              "fleet.launch", "train.sharded_step", "train.resident_step", "train.trainer",
              "data.dataset", "data.device_pack", "serve.scoring_table", "serve.server",
              "obs.trace_context", "obs.flight_recorder", "obs.metrics_writer", "utils.trace",
              "utils.line_reader", "data.data_generator", "data.quarantine", "metrics.auc_runner",
              "utils.backendguard", "train.supervisor", "train.stream", "ops.host_codec",
              "parallel.transport", "parallel.membership", "table.dist_ws", "data.record_store",
              "serve.fleet", "parallel.pipeline", "parallel.ring_attention"):
        assert f"paddlebox_tpu_torch.{m}" in walked


def test_no_file_names_the_jax_package():
    pat = re.compile(r"paddlebox_tpu(?!_torch)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "paddlebox_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu"))]
    # the sanctioned mentions: chip_smoke.py's kernels line names the
    # file:line of the TPU kernel each CUDA kernel replaces
    replaces = re.compile(
        r'^(GATHER|WRITE)_REPLACES = "paddlebox_tpu/ops/pallas_kernels\.py:\d+"$'
    )
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if pat.search(line) and not replaces.match(line.rstrip("\n")):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{i}")
    assert offenders == []


def test_scorer_without_device_raises_on_a_host_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid here")
    cfg = TrainStepConfig(num_slots=2, batch_size=4, layout=ValueLayout(embedx_dim=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scorer(torch.nn.Linear(1, 1), cfg)


def test_trainer_without_device_raises_on_a_host_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid here")
    cfg = TrainStepConfig(num_slots=2, batch_size=4, layout=ValueLayout(embedx_dim=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CTRTrainer(torch.nn.Linear(1, 1), cfg)


def test_torch_distributed_is_reached_only_through_the_mesh():
    """Data collectives go through ``MeshPlan``: no module of the port but
    ``parallel/mesh.py`` imports ``torch.distributed``."""
    pat = re.compile(r"^\s*(import torch\.distributed|from torch\.distributed|from torch import distributed)")
    offenders = []
    for root, _, names in os.walk(os.path.join(REPO, "paddlebox_tpu_torch")):
        for n in names:
            path = os.path.join(root, n)
            if not n.endswith(".py") or path.endswith(os.path.join("parallel", "mesh.py")):
                continue
            with open(path, encoding="utf-8") as f:
                offenders += [f"{os.path.relpath(path, REPO)}:{i}" for i, line in enumerate(f, 1) if pat.match(line)]
    assert offenders == []


# Hooks a user's subclass must override, raising ``NotImplementedError``
# as the JAX package's do: abstract methods, not paths the port refuses.
# Keyed by file, each the names of the methods.
ABSTRACT_HOOKS = {
    os.path.join("paddlebox_tpu_torch", "data", "data_generator.py"): ("generate_sample", "_gen_str"),
}


def _enclosing_def(lines, i):
    for line in reversed(lines[: i + 1]):
        m = re.match(r"\s*def (\w+)\(", line)
        if m:
            return m.group(1)
    return None


def test_every_refusal_names_its_roadmap_item():
    """A path the port does not take raises ``NotImplementedError`` whose
    message names the ROADMAP queue item that owes it. The abstract hooks
    of ``ABSTRACT_HOOKS`` are not refusals; each must exist and raise."""
    pat = re.compile(r"raise NotImplementedError\b")
    offenders, hooks = [], set()
    for root, _, names in os.walk(os.path.join(REPO, "paddlebox_tpu_torch")):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(root, n)
            rel = os.path.relpath(path, REPO)
            with open(path, encoding="utf-8") as f:
                lines = f.readlines()
            for i, line in enumerate(lines):
                if not pat.search(line):
                    continue
                fn = _enclosing_def(lines, i)
                if fn in ABSTRACT_HOOKS.get(rel, ()):
                    hooks.add((rel, fn))
                elif not re.search(r"ROADMAP Queue \d", "".join(lines[i : i + 4])):
                    offenders.append(f"{rel}:{i + 1}")
    assert offenders == []
    assert hooks == {(rel, fn) for rel, fns in ABSTRACT_HOOKS.items() for fn in fns}
