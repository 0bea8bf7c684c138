"""The port's CUDA bring-up watchdog: ``backend.init`` faults spend the
retries with a doubling backoff and then raise, with no CPU verdict; the
wedge is a flight-recorder incident; a CPU device skips the probe. A real
probe on a host without a GPU fails as a wedge does (its subprocess
cannot initialize CUDA), within the watchdog."""

from __future__ import annotations

import json
import time

import pytest
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.obs.flight_recorder import FLIGHT_RECORDER
from paddlebox_tpu_torch.utils import backendguard
from paddlebox_tpu_torch.utils.backendguard import (
    BackendUnavailableError,
    BackendVerdict,
    ensure_backend,
    probe_backend,
    probe_backend_with_retries,
)
from paddlebox_tpu_torch.utils.faultinject import fail_always, fail_once, inject
from paddlebox_tpu_torch.utils.monitor import STAT_GET

torch.set_num_threads(2)


def test_wedged_init_raises_after_the_retries_with_no_cpu_verdict(tmp_path):
    slept = []
    prev = config.get_flag("obs_incident_dir")
    config.set_flag("obs_incident_dir", str(tmp_path))
    probes0 = STAT_GET("backend.init_probes")
    t0 = time.monotonic()
    try:
        with inject(fail_always("backend.init")) as plan:
            with pytest.raises(BackendUnavailableError) as ei:
                ensure_backend("cuda", timeout_s=2.0, retries=3, backoff_s=0.5, sleep=slept.append)
            assert plan.failures("backend.init") == 3
    finally:
        config.set_flag("obs_incident_dir", prev)
    assert time.monotonic() - t0 < 5.0
    assert slept == [0.5, 1.0]  # doubling, between probes only
    assert STAT_GET("backend.init_probes") == probes0 + 3
    assert STAT_GET("backend.init_wedged") == 1
    assert len(ei.value.probe_log) == 3 and not any(e["ok"] for e in ei.value.probe_log)
    assert "wedged" in str(ei.value)
    assert FLIGHT_RECORDER.snapshot()["incidents"][-1]["kind"] == "backend_wedge"
    (bundle,) = list(tmp_path.glob("incident-*.json"))
    assert json.loads(bundle.read_text())["reason"] == "backend_wedge"


def test_cpu_device_skips_the_probe():
    probes0 = STAT_GET("backend.init_probes")
    with inject(fail_always("backend.init")) as plan:
        v = ensure_backend("cpu")
        assert plan.hits("backend.init") == 0
    assert STAT_GET("backend.init_probes") == probes0
    assert (v.platform, v.verdict, v.probed) == ("cpu", "ok", False)
    assert v.as_dict() == {"platform": "cpu", "n_devices": 1, "verdict": "ok", "probed": False}
    with pytest.raises(ValueError):
        ensure_backend("meta")


def test_a_live_cuda_context_skips_the_probe(monkeypatch):
    """A CUDA context this process already holds is trusted: nothing is
    left to wedge, and no probe runs."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "stub card")
    with inject(fail_always("backend.init")) as plan:
        v = ensure_backend("cuda")
        assert plan.hits("backend.init") == 0
        assert (v.platform, v.n_devices, v.kind, v.probed) == ("gpu", 1, "stub card", False)


def test_retry_recovers_from_a_transient_wedge(monkeypatch):
    """One injected wedge, then a probe that answers: "ok" on the second
    probe (the subprocess is replaced by a stub answer)."""
    calls = []

    def fake_run(cmd, capture_output, text, timeout):
        calls.append(cmd)

        class P:
            returncode = 0
            stdout = json.dumps({"platform": "gpu", "n_devices": 1, "kind": "stub"}) + "\n"
            stderr = ""

        return P()

    monkeypatch.setattr(backendguard.subprocess, "run", fake_run)
    with inject(fail_once("backend.init")):
        v = ensure_backend("cuda", timeout_s=1.0, retries=3, backoff_s=0.0, sleep=lambda s: None)
    assert isinstance(v, BackendVerdict) and v.verdict == "ok" and v.probed and v.kind == "stub"
    assert [e["ok"] for e in v.probe_log] == [False, True] and len(calls) == 1
    info, log = probe_backend_with_retries(timeout_s=1.0, retries=1, sleep=lambda s: None)
    assert info["platform"] == "gpu" and log[0]["ok"]


def test_a_real_probe_without_a_gpu_fails_inside_the_watchdog():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the probe would succeed")
    t0 = time.monotonic()
    info, err = probe_backend(timeout_s=60.0)
    assert info is None and "CUDA init failed" in err
    assert time.monotonic() - t0 < 60.0
