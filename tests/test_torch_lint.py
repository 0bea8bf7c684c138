"""The port under the JAX package's lint: ``paddlebox_tpu_torch`` must lint
clean (no error, no warning) under ``default_rules()`` and the per-root
profiles, resolved over the port alone, and the gate must be live (a
doctored copy of a port module fails). ``python tools/run_lint.py
--no-baseline paddlebox_tpu_torch`` is the same check resolved over the
default roots too."""

import os
import shutil

from paddlebox_tpu.analysis import DEFAULT_PROFILES, ERROR, WARNING, default_rules, lint_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddlebox_tpu_torch")


def _lint(root, port):
    result = lint_paths([port], default_rules(), root=root, context_paths=[port], profiles=DEFAULT_PROFILES)
    assert result.parse_errors == [], result.parse_errors
    return result.findings


def test_port_lints_clean():
    findings = _lint(REPO, PORT)
    errors = [f for f in findings if f.severity == ERROR]
    warnings = [f for f in findings if f.severity == WARNING]
    assert errors == [] and warnings == [], "\n" + "\n".join(f.render() for f in findings)


def test_gate_is_live_on_a_port_module(tmp_path):
    port = tmp_path / "paddlebox_tpu_torch"
    (port / "data").mkdir(parents=True)
    module = port / "data" / "pipeline.py"
    shutil.copy(os.path.join(PORT, "data", "pipeline.py"), module)
    assert _lint(str(tmp_path), str(port)) == []
    with open(module, "a") as f:
        f.write("\n\ndef _count(kind):\n    STAT_ADD(f\"pipeline.{kind}\")\n")
    findings = _lint(str(tmp_path), str(port))
    assert [(f.rule, f.severity, f.path) for f in findings] == [
        ("MON005", ERROR, "paddlebox_tpu_torch/data/pipeline.py")
    ]
