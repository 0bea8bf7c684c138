"""PassSupervisor: the self-healing pass/day loop, on one host.

Port of the JAX package's ``train/supervisor.py`` for a single process. It
composes the recovery pieces: PassGuard confirm/revert
(``train/rollback.py``), the fs tier's retry-until-open, the step's NaN
containment and the checkpoint chain's resume. One supervised pass runs

    load (fs retries inside) -> begin_pass(enable_revert) [guard armed]
      -> prepare_pass -> train_pass -> health gates -> end_pass [confirm]
      -> a checkpoint publish (base or delta, manifest-verified)

An exception or a gate's rejection reverts the pass (the retrain after a
revert equals an uninterrupted run bit for bit) and retries it under a
bounded exponential backoff. When ``max_retries`` is spent the supervisor
escalates once: ``CheckpointManager.resume`` restores the last durable
state and the pass re-enters with a fresh budget. Every action is an
:class:`Incident` in ``self.incidents``, a ``supervisor_*`` counter, an
instant in the profiler's timeline and, for the kinds that lose a pass, a
flight-recorder bundle under ``<checkpoint root>/obs/incidents``; a
``MetricsWriter`` there records a series point each pass.

Health gates: the ratio of NaN-skipped batches (``nan_ratio_max``), and
the pass AUC against the trailing mean of the last ``auc_window``
confirmed passes less ``auc_floor_margin`` (after ``auc_min_history``
confirmations), or an absolute floor.

Poisoned data is not a transient fault: a load that quarantined more than
the admission thresholds (``data/quarantine.py``) replays the same
corruption on every retry, so it is resolved before the retry loop under
``on_poisoned``: "fail" raises :class:`DataPoisonedError`, "skip_pass"
drops the pass, "degrade" trains it over the records that survived.

``run_day`` kicks the next pass's load into the dataset's boundary feed
stage while the current pass trains (flag ``boundary_pipeline``), and the
next ``run_pass`` adopts it.

The supervisor brings the device up through ``utils/backendguard.py``
when the trainer is on CUDA (it raises when the card never comes up). The
port compiles nothing at run time, so ``compile_cache_dir`` "auto" and
"off" do nothing.

Not ported (ROADMAP Queue 1 item 5.3): a supervisor over several ranks (a
``transport``, a trainer whose mesh has more than one rank: every rank
would need the verdict exchange to agree on a retry), elastic membership
(``elastic=``) and ``join_day``.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data.quarantine import DataPoisonedError
from paddlebox_tpu_torch.obs.flight_recorder import FLIGHT_RECORDER
from paddlebox_tpu_torch.obs.metrics_writer import MetricsWriter
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_OBSERVE
from paddlebox_tpu_torch.utils.trace import PROFILER

# the incident vocabulary (each kind counted as supervisor_<kind>), and the
# kinds that lose a pass (or the day): each flushes the flight recorder
# into an incident bundle
_INCIDENT_KINDS = (
    "load_error", "prefetch_error", "data_poisoned", "ckpt_save_error", "train_error", "escalate_resume",
    "gave_up", "gate_nan", "gate_auc",
)
_FATAL_INCIDENT_KINDS = ("data_poisoned", "gave_up")

config.define_flag(
    "supervisor_max_retries",
    2,
    "revert+retry attempts per pass before the supervisor escalates to a "
    "checkpoint resume (and, failing that, gives up)",
)
config.define_flag(
    "on_poisoned_pass",
    "fail",
    "supervisor policy when a pass's load quarantined data beyond the "
    "admission thresholds (DataPoisonedError, never retried): 'fail' "
    "raises, 'skip_pass' drops the pass and continues the day, 'degrade' "
    "trains over the pass with the quarantined records dropped",
)
config.define_flag(
    "compile_cache_dir",
    "auto",
    "the JAX package's persistent compile cache; the port compiles nothing "
    "at run time (its kernels build once into _build/), so 'auto' and 'off' "
    "do nothing and a directory is refused",
)


class PassRejected(RuntimeError):
    """A health gate rejected an otherwise completed pass."""

    def __init__(self, gate: str, detail: str):
        super().__init__(f"pass rejected by {gate} gate: {detail}")
        self.gate = gate
        self.detail = detail


class PassFailure(RuntimeError):
    """The supervisor exhausted the retries and the escalation of a pass."""


@dataclass
class HealthGates:
    nan_ratio_max: float = 0.05
    auc_window: int = 5
    auc_min_history: int = 3
    auc_floor_margin: float = 0.05
    auc_absolute_floor: Optional[float] = None


@dataclass
class RetryPolicy:
    max_retries: Optional[int] = None  # None: the supervisor_max_retries flag
    backoff_s: float = 0.5
    backoff_mult: float = 2.0
    backoff_max_s: float = 30.0
    # injectable, so chaos schedules need not sleep
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    @property
    def retries(self) -> int:
        if self.max_retries is not None:
            return self.max_retries
        return int(config.get_flag("supervisor_max_retries"))

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_s * self.backoff_mult ** max(0, attempt - 1), self.backoff_max_s)


@dataclass
class Incident:
    """One entry of the supervisor's incident log."""

    pass_seq: int
    date: Optional[str]
    kind: str  # load_error | train_error | gate_nan | gate_auc | prefetch_error |
    #            ckpt_save_error | escalate_resume | gave_up | data_poisoned
    action: str  # retry | revert_retry | resume | raise | skip | degrade | deferred
    attempt: int
    detail: str = ""
    wall_time: float = field(default_factory=time.time)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "pass_seq": self.pass_seq, "date": self.date, "kind": self.kind, "action": self.action,
            "attempt": self.attempt, "detail": self.detail, "wall_time": self.wall_time,
        }


class PassSupervisor:
    """Fault-tolerant driver of one trainer's pass/day loop.

    ``checkpoint`` (a CheckpointManager) enables the escalation path, the
    per-pass publishing of ``run_day``, the metric series and the incident
    bundles; without it the supervisor still reverts and retries, but
    gives up when the retries are spent."""

    def __init__(
        self,
        dataset,
        trainer,
        checkpoint=None,
        gates: Optional[HealthGates] = None,
        retry: Optional[RetryPolicy] = None,
        round_to: int = 512,
        shrink: bool = True,
        on_give_up: str = "raise",  # raise | skip (drop the pass, keep the day)
        transport=None,
        on_poisoned: Optional[str] = None,  # None: the on_poisoned_pass flag
        elastic=None,
    ):
        if on_give_up not in ("raise", "skip"):
            raise ValueError(f"on_give_up must be 'raise' or 'skip', got {on_give_up!r}")
        if on_poisoned not in (None, "fail", "skip_pass", "degrade"):
            raise ValueError(f"on_poisoned must be None, 'fail', 'skip_pass' or 'degrade', got {on_poisoned!r}")
        if transport is not None and getattr(transport, "n_ranks", 1) > 1:
            raise NotImplementedError(
                "a supervisor over several ranks exchanges a verdict a pass over the host "
                "transport: ROADMAP Queue 1 item 5.3"
            )
        if elastic is not None:
            raise NotImplementedError("elastic membership needs the host transport: ROADMAP Queue 1 item 5.3")
        plan = getattr(trainer, "plan", None)
        if plan is not None and plan.world > 1:
            raise NotImplementedError(
                "a supervisor over a mesh trainer needs every rank to agree on a retry "
                "(the coordinator of ROADMAP Queue 1 item 5.3)"
            )
        cache = str(config.get_flag("compile_cache_dir"))
        if cache not in ("auto", "off", ""):
            raise NotImplementedError(
                f"compile_cache_dir={cache!r}: the port compiles nothing at run time, and a "
                "persistent cache of its own is ROADMAP Queue 1 item 6"
            )
        self.ds = dataset
        self.tr = trainer
        self.table = dataset.table
        self.checkpoint = checkpoint
        self.gates = gates or HealthGates()
        self.retry = retry or RetryPolicy()
        self.round_to = round_to
        self.shrink = shrink
        self.on_give_up = on_give_up
        self._on_poisoned = on_poisoned
        # a poisoned pass admitted under "degrade": its begin_pass (and any
        # retry of it) passes the gate
        self._admit_poisoned = False
        # the dead letters of a checkpointed run live beside its checkpoints
        if checkpoint is not None and getattr(dataset, "quarantine_dir", "absent") is None:
            dataset.quarantine_dir = os.path.join(checkpoint.root, "quarantine")
        self.backend_verdict = None
        device = getattr(trainer, "device", None)
        if device is not None and getattr(device, "type", None) == "cuda":
            from paddlebox_tpu_torch.utils import backendguard

            self.backend_verdict = backendguard.ensure_backend(device)
        # the telemetry plane lives under the checkpoint root (obs/), so a
        # postmortem travels with the artifacts it explains
        self.metrics: Optional[MetricsWriter] = None
        self._incident_dir: Optional[str] = None
        if checkpoint is not None:
            obs_dir = os.path.join(checkpoint.root, "obs")
            self.metrics = MetricsWriter(obs_dir, rank=0)
            self._incident_dir = os.path.join(obs_dir, "incidents")
        self.incidents: List[Incident] = []
        self._auc_history: deque = deque(maxlen=self.gates.auc_window)
        self._pass_seq = 0
        self._date: Optional[str] = None
        # (date, files) of the pass whose load was kicked into the feed
        # stage. It also records that its set_date ran at kick time, so the
        # run_pass that adopts it must not call set_date again (pass_id
        # would move, and with it the load's sampling and shuffle seeds)
        self._prefetch: Optional[tuple] = None

    # ---- the incident log ----------------------------------------------------

    def _record(self, kind: str, action: str, attempt: int, detail: str = "") -> Incident:
        inc = Incident(pass_seq=self._pass_seq, date=self._date, kind=kind, action=action, attempt=attempt, detail=detail)
        self.incidents.append(inc)
        STAT_ADD("supervisor_incidents")
        STAT_ADD(f"supervisor_{kind}" if kind in _INCIDENT_KINDS else "supervisor_other")
        PROFILER.instant(f"supervisor:{kind}", inc.as_dict())
        if kind in _FATAL_INCIDENT_KINDS and action != "degrade":
            # the pass is lost: the last spans, the stats and this incident
            FLIGHT_RECORDER.dump(f"supervisor_{kind}", detail, dir_path=self._incident_dir)
        return inc

    # ---- pieces ----------------------------------------------------------------

    def _load_with_retry(self, date: Optional[str], files: Sequence[str]) -> None:
        for attempt in range(self.retry.retries + 1):
            try:
                if date is not None:
                    self.ds.set_date(date)
                self.ds.set_filelist(list(files))
                self.ds.load_into_memory()
                return
            except Exception as e:
                # the fs tier spent its own retries: the input is still
                # missing, or the reader died mid-stream
                if attempt >= self.retry.retries:
                    self._record("load_error", "raise", attempt, repr(e))
                    raise PassFailure(f"load failed after {attempt + 1} attempts: {e}") from e
                self._record("load_error", "retry", attempt, repr(e))
                self.retry.sleep(self.retry.backoff(attempt + 1))

    def _kick_prefetch(self, date: Optional[str], files: Sequence[str]) -> None:
        """Stage the next pass's load (read, key premerge, gated host-row
        prefetch) on the preload thread while this pass trains. A failure
        here is an incident, never an attempt's failure: the next run_pass
        loads synchronously instead."""
        if not config.get_flag("boundary_pipeline"):
            return
        key = (date, tuple(files))
        try:
            if date is not None and self._prefetch != key:
                self.ds.set_date(date)
            self._prefetch = key  # set_date is consumed: a fallback load skips it
            self.ds.set_filelist(list(files))
            self.ds.preload_into_memory()
        except Exception as e:
            self._record("prefetch_error", "deferred", 0, repr(e))

    def _adopt_prefetch(self, date: Optional[str], files: Sequence[str]) -> None:
        """Take (or cancel) a kicked prefetch, then make sure the pass's
        data is staged, with the synchronous retrying load when the kick
        failed, was reverted away or named another pass."""
        marker, self._prefetch = self._prefetch, None
        key = (date, tuple(files))
        if marker == key:
            staged = False
            try:
                self.ds.wait_preload_done()
                # a revert (or a failed kick) may have dropped the staged slot
                staged = self.ds._staged is not None
            except Exception as e:
                self._record("prefetch_error", "retry", 0, repr(e))
                self.ds.discard_staged()
            if not staged:
                self._load_with_retry(None, files)  # set_date ran at kick time
            return
        if marker is not None:
            # a kick for another pass: the caller changed the schedule
            try:
                self.ds.wait_preload_done()
            except Exception:
                STAT_ADD("supervisor_stale_preload_errors")
            self.ds.discard_staged()
        self._load_with_retry(date, files)

    @property
    def on_poisoned(self) -> str:
        """The poisoned-pass policy: the constructor's, else the flag's."""
        v = self._on_poisoned or str(config.get_flag("on_poisoned_pass"))
        if v not in ("fail", "skip_pass", "degrade"):
            raise ValueError(f"on_poisoned_pass must be fail|skip_pass|degrade, got {v!r}")
        return v

    def _poison_report(self) -> Optional[Dict[str, Any]]:
        rep_fn = getattr(self.ds, "admission_report", None)
        return rep_fn() if rep_fn is not None else None

    def _handle_poisoned(self, detail: str, rep: Optional[Dict[str, Any]]) -> bool:
        """Apply the on_poisoned policy: True trains the pass (degrade),
        False drops it (skip_pass); "fail" raises DataPoisonedError."""
        policy = self.on_poisoned
        loss = ""
        if rep is not None and (rep["bad_lines"] or rep["bad_files"]):
            loss = (
                f" (loss: {rep['bad_lines']} lines / {rep['bad_files']} files, "
                f"line_fraction={rep['line_fraction']:.5f})"
            )
        if policy == "degrade":
            self._record("data_poisoned", "degrade", 0, detail + loss)
            self._admit_poisoned = True
            return True
        if policy == "skip_pass":
            self._record("data_poisoned", "skip", 0, detail + loss)
            drop = getattr(self.ds, "drop_pass_data", None)
            if drop is not None:
                drop()
            return False
        self._record("data_poisoned", "raise", 0, detail + loss)
        raise DataPoisonedError(detail, report=rep, dead_letter=(rep or {}).get("dead_letter"))

    def _gate(self, out: Dict[str, float]) -> None:
        g = self.gates
        batches = out.get("batches", 0.0)
        if batches:
            ratio = out.get("nan_batches", 0.0) / batches
            if ratio > g.nan_ratio_max:
                raise PassRejected("nan", f"{ratio:.3f} of batches NaN-skipped (max {g.nan_ratio_max:.3f})")
        auc = out.get("auc")
        if auc is None or not np.isfinite(auc):
            return
        if g.auc_absolute_floor is not None and auc < g.auc_absolute_floor:
            raise PassRejected("auc", f"auc {auc:.4f} under absolute floor {g.auc_absolute_floor:.4f}")
        if len(self._auc_history) >= g.auc_min_history:
            floor = float(np.mean(self._auc_history)) - g.auc_floor_margin
            if auc < floor:
                raise PassRejected(
                    "auc",
                    f"auc {auc:.4f} under trailing floor {floor:.4f} "
                    f"(window of {len(self._auc_history)} confirmed passes)",
                )

    def _attempt(self, n_batches: Optional[int], prefetch: Optional[tuple] = None) -> Dict[str, float]:
        """One armed begin -> train -> gate -> confirm cycle."""
        if not self.ds._in_pass:
            # the first attempt, or a revert re-armed the records
            kw = {"admit_poisoned": True} if self._admit_poisoned else {}
            self.ds.begin_pass(round_to=self.round_to, enable_revert=True, trainer=self.tr, **kw)
        self.tr.prepare_pass(self.ds, n_batches)
        if prefetch is not None:
            # training is about to take the device: stage the next load
            self._kick_prefetch(prefetch[0], prefetch[1])
        out = self.tr.train_pass(self.ds, n_batches=n_batches)
        # the trained table landed: the host writeback starts now, beside
        # the gates (a revert cancels it and restores the rows)
        trained = self.tr.trained_table()
        if hasattr(self.ds, "kick_writeback"):
            self.ds.kick_writeback(trained)
        self._gate(out)
        # a guard is armed, so the boundary is the classic one (host rows)
        self.ds.end_pass(trained, shrink=self.shrink)
        return out

    def _revert(self, attempt: int, cause: BaseException) -> None:
        kind = f"gate_{cause.gate}" if isinstance(cause, PassRejected) else "train_error"
        try:
            self.ds.revert_pass()
        except Exception as e:
            # an unrevertable pass can only be healed by the durable tier
            self._record(kind, "revert_failed", attempt, f"{cause!r}; revert: {e!r}")
            raise PassFailure(f"revert failed after {cause!r}: {e}") from e
        self._record(kind, "revert_retry", attempt, repr(cause))

    def _escalate(self, attempt: int, cause: BaseException) -> None:
        """Resume the last durable (manifest-verified) state and re-enter."""
        state = self.checkpoint.resume(self.table, self.tr)
        # the table rows and dense params were overwritten from outside:
        # the trainer's device state is stale
        self.tr.drop_device_state()
        self._record("escalate_resume", "resume", attempt, f"{cause!r} -> resumed {state}")

    def _save_checkpoint(self, mode: str) -> None:
        assert self.checkpoint is not None
        for attempt in range(self.retry.retries + 1):
            try:
                if mode == "base":
                    self.checkpoint.save_base(self._date, self.table, self.tr)
                else:
                    self.checkpoint.save_delta(self._date, self.table, self.tr)
                return
            except Exception as e:
                # an atomic publish leaves nothing under a final name: a
                # retry starts clean
                if attempt >= self.retry.retries:
                    self._record("ckpt_save_error", "raise", attempt, repr(e))
                    raise PassFailure(f"checkpoint {mode} save failed after {attempt + 1} attempts: {e}") from e
                self._record("ckpt_save_error", "retry", attempt, repr(e))
                self.retry.sleep(self.retry.backoff(attempt + 1))

    # ---- the supervised pass ---------------------------------------------------

    def run_pass(
        self,
        files: Sequence[str],
        date: Optional[str] = None,
        n_batches: Optional[int] = None,
        save: Optional[str] = None,  # None | "base" | "delta"
        prefetch: Optional[tuple] = None,  # (date, files) of the next pass
    ) -> Optional[Dict[str, float]]:
        """Load, train, gate and publish one pass, healing failures.
        ``prefetch`` names the next pass: its load is kicked once training
        starts, and the next run_pass over the same (date, files) adopts
        it. Returns the pass metrics, or None when the pass was dropped
        (``skip_pass``, or ``on_give_up="skip"`` after the escalation)."""
        if save not in (None, "base", "delta"):
            raise ValueError(f"save must be None, 'base' or 'delta', got {save!r}")
        if save is not None and self.checkpoint is None:
            raise ValueError("save requires a CheckpointManager")
        self._pass_seq += 1
        self._date = date if date is not None else self._date
        self._admit_poisoned = False
        pass_t0 = time.monotonic()
        self._adopt_prefetch(date, files)
        # poisoned data is deterministic: resolved before the retry loop
        rep = self._poison_report()
        if rep is not None and rep["poisoned"] and not self._handle_poisoned(rep["detail"], rep):
            return None
        escalated = False
        attempt = 0
        while True:
            try:
                with PROFILER.record_event("supervised_pass_attempt", "supervisor"):
                    out = self._attempt(n_batches, prefetch=prefetch)
                break
            except DataPoisonedError as e:
                # the thresholds or the policy changed under a live attempt:
                # still deterministic, never retried
                self._record("data_poisoned", "raise", attempt, repr(e))
                raise
            except Exception as e:
                self._revert(attempt, e)
                attempt += 1
                if attempt > self.retry.retries:
                    if not escalated and self.checkpoint is not None:
                        self._escalate(attempt, e)
                        escalated = True
                        attempt = 0
                        continue
                    if self.on_give_up == "skip":
                        self._record("gave_up", "skip", attempt, repr(e))
                        return None
                    self._record("gave_up", "raise", attempt, repr(e))
                    raise PassFailure(
                        f"pass {self._pass_seq} failed after retries" + (" and checkpoint resume" if escalated else "")
                    ) from e
                self.retry.sleep(self.retry.backoff(attempt))
        if self._admit_poisoned and rep is not None:
            # what a degraded pass lost, in its metrics
            out["quarantined_line_fraction"] = float(rep["line_fraction"])
            out["quarantined_bad_lines"] = float(rep["bad_lines"])
            out["quarantined_bad_files"] = float(rep["bad_files"])
        auc = out.get("auc")
        if auc is not None and np.isfinite(auc):
            self._auc_history.append(float(auc))
        if save is not None:
            self._save_checkpoint(save)
        STAT_OBSERVE("supervisor.pass_s", time.monotonic() - pass_t0)
        if self.metrics is not None:
            self.metrics.snapshot(
                f"pass:{self._pass_seq}",
                extra={k: float(v) for k, v in out.items() if isinstance(v, (int, float)) and np.isfinite(v)},
            )
        return out

    def run_day(
        self,
        date: str,
        pass_files: Sequence[Sequence[str]],
        n_batches: Optional[int] = None,
        publish: bool = True,
    ) -> List[Optional[Dict[str, float]]]:
        """One day: a base save after the first pass, a delta after each
        of the rest (SaveBase and the per-pass need_save_delta cadence);
        ``publish=False`` trains without checkpointing."""
        outs: List[Optional[Dict[str, float]]] = []
        do_save = publish and self.checkpoint is not None
        for p, files in enumerate(pass_files):
            mode = None if not do_save else ("base" if p == 0 else "delta")
            nxt = (date, tuple(pass_files[p + 1])) if p + 1 < len(pass_files) else None
            outs.append(self.run_pass(files, date=date, n_batches=n_batches, save=mode, prefetch=nxt))
            if self.metrics is not None:
                self.metrics.maybe_snapshot()
        return outs

    def join_day(self, *args, **kwargs):
        raise NotImplementedError("join_day admits a rank into a running fleet: ROADMAP Queue 1 item 5.3")
