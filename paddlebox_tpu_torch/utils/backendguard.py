"""Watchdogged CUDA bring-up, with no fallback.

A CUDA driver or device that does not come up (a card lost off the bus, a
driver stuck in init) can hang the first touch of the device forever, and
a hang inside this process cannot be killed. So the first touch happens in
a subprocess under a hard watchdog (``torch.cuda.init()`` and one small
tensor on ``cuda:0``); only after the probe reports a live device does the
caller use CUDA itself.

Contract (the JAX package's ``utils/backendguard.py``, with one change):

- ``probe_backend``   one subprocess probe under ``backend_init_timeout_s``;
                      the ``backend.init`` fault site lets chaos tests
                      simulate a wedged device deterministically.
- ``probe_backend_with_retries``  probes with a doubling backoff
                      (``backend_init_retries``, ``backend_init_backoff_s``).
- ``ensure_backend``  the retry loop and the decision. It returns a
                      :class:`BackendVerdict` with ``verdict == "ok"``, or,
                      after the retries, notes a ``backend_wedge`` incident
                      in the flight recorder (dumped when a dump directory
                      is set) and raises :class:`BackendUnavailableError`.
                      There is no CPU verdict: the port's work is on the
                      card, and a run that quietly moved to the CPU would
                      report numbers of the wrong device.

A caller that asked for the CPU (``device="cpu"``) skips the probe: it
gets an "ok" verdict for the CPU without a subprocess. So does a process
whose CUDA context is already up (the JAX package's short cut for an
initialized backend): init has nothing left to wedge.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.utils.faultinject import InjectedFault, fire
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_SET

config.define_flag(
    "backend_init_timeout_s",
    120.0,
    "watchdog on each subprocess CUDA-init probe: a device that does not "
    "come up within this is declared wedged (the probe child is killed; a "
    "hung in-process init would be unkillable)",
)
config.define_flag(
    "backend_init_retries",
    6,
    "CUDA-init probes before ensure_backend gives up and raises",
)
config.define_flag(
    "backend_init_backoff_s",
    30.0,
    "first sleep between CUDA-init probes, doubled each retry and capped at 120s",
)

_PROBE = (
    "import json, torch; torch.cuda.init(); "
    "x = torch.ones(8, device='cuda:0'); torch.cuda.synchronize(); "
    "assert float(x.sum()) == 8.0; "
    "print(json.dumps({'platform': 'gpu', 'n_devices': torch.cuda.device_count(), "
    "'kind': torch.cuda.get_device_name(0)}))"
)


class BackendUnavailableError(RuntimeError):
    """The CUDA device never came up within the probe budget."""

    def __init__(self, detail: str, probe_log: List[Dict]):
        super().__init__(detail)
        self.detail = detail
        self.probe_log = probe_log


@dataclass
class BackendVerdict:
    """Outcome of the bring-up. ``verdict`` is always "ok": a device that
    does not come up raises instead."""

    platform: str  # "gpu" or "cpu"
    n_devices: int
    verdict: str = "ok"
    probed: bool = False  # at least one subprocess probe ran
    kind: Optional[str] = None  # the card's name
    probe_log: List[Dict] = field(default_factory=list)

    def as_dict(self) -> Dict:
        d = {"platform": self.platform, "n_devices": self.n_devices, "verdict": self.verdict, "probed": self.probed}
        if self.kind is not None:
            d["kind"] = self.kind
        if self.probe_log:
            d["probe_log"] = self.probe_log
        return d


def probe_backend(timeout_s: Optional[float] = None) -> Tuple[Optional[dict], Optional[str]]:
    """Initialize CUDA in a subprocess with a hard timeout. Returns
    ``(info, None)`` ({"platform", "n_devices", "kind"}) or ``(None,
    reason)``; a hung child is killed at the deadline. The ``backend.init``
    fault site fires first."""
    if timeout_s is None:
        timeout_s = float(config.get_flag("backend_init_timeout_s"))
    STAT_ADD("backend.init_probes")
    try:
        fire("backend.init")
    except InjectedFault as e:
        return None, f"backend init wedged (injected: {e})"
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None, f"CUDA init timed out after {timeout_s:.0f}s (wedged device?)"
    if proc.returncode != 0:
        tail = (proc.stderr or "").strip().splitlines()[-3:]
        return None, f"CUDA init failed rc={proc.returncode}: " + " | ".join(tail)
    try:
        return json.loads(proc.stdout.strip().splitlines()[-1]), None
    except (ValueError, IndexError):
        return None, f"CUDA probe produced no JSON: {proc.stdout[-200:]!r}"


def probe_backend_with_retries(
    timeout_s: Optional[float] = None,
    retries: Optional[int] = None,
    backoff_s: Optional[float] = None,
    sleep=time.sleep,
) -> Tuple[Optional[dict], List[Dict]]:
    """Probe up to ``retries`` times with a doubling backoff (capped at
    120 s). Returns ``(info, probe_log)``; ``info`` is None when every
    probe failed. Each log entry is {"ts", "elapsed_s", "ok", "detail"}."""
    if retries is None:
        retries = max(1, int(config.get_flag("backend_init_retries")))
    if backoff_s is None:
        backoff_s = float(config.get_flag("backend_init_backoff_s"))
    probe_log: List[Dict] = []
    for attempt in range(retries):
        t0 = time.time()
        info, err = probe_backend(timeout_s)
        entry = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t0)),
            "elapsed_s": round(time.time() - t0, 1),
            "ok": err is None,
            "detail": "ok" if err is None else err,
        }
        probe_log.append(entry)
        # progress on stderr as it happens, for a driver with a watchdog
        print(f"[backendguard] probe {attempt + 1}/{retries}: {entry['detail']}", file=sys.stderr, flush=True)
        if err is None:
            return info, probe_log
        if attempt + 1 < retries:
            sleep(min(backoff_s, 120.0))
            backoff_s *= 2
    return None, probe_log


def ensure_backend(
    device="cuda",
    timeout_s: Optional[float] = None,
    retries: Optional[int] = None,
    backoff_s: Optional[float] = None,
    sleep=time.sleep,
) -> BackendVerdict:
    """Bring up the device the caller asked for. A CPU device needs no
    probe, nor does a CUDA context this process already holds. Otherwise
    probe in a subprocess with retries; when every probe failed, note a
    ``backend_wedge`` incident (and dump the flight recorder when
    ``obs_incident_dir`` is set) and raise :class:`BackendUnavailableError`."""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        return BackendVerdict(platform="cpu", n_devices=1)
    if dev.type != "cuda":
        raise ValueError(f"ensure_backend: device {device!r} is neither cuda nor cpu")
    if torch.cuda.is_initialized():
        return BackendVerdict(
            platform="gpu", n_devices=torch.cuda.device_count(), kind=torch.cuda.get_device_name(0)
        )
    info, probe_log = probe_backend_with_retries(timeout_s, retries, backoff_s, sleep=sleep)
    if info is not None:
        return BackendVerdict(
            platform=str(info["platform"]), n_devices=int(info["n_devices"]), probed=True,
            kind=info.get("kind"), probe_log=probe_log,
        )
    STAT_SET("backend.init_wedged", 1)
    err = probe_log[-1]["detail"] if probe_log else "no probe ran"
    from paddlebox_tpu_torch.obs.flight_recorder import FLIGHT_RECORDER

    FLIGHT_RECORDER.note_incident("backend_wedge", {"error": err, "probes": len(probe_log)})
    FLIGHT_RECORDER.dump("backend_wedge", detail=err)
    raise BackendUnavailableError(
        f"CUDA device did not come up after {len(probe_log)} probes: {err}", probe_log
    )
