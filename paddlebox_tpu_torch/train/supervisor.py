"""PassSupervisor: the self-healing pass/day loop, on one host or over several.

Port of the JAX package's ``train/supervisor.py``. It composes the recovery
pieces: PassGuard confirm/revert (``train/rollback.py``), the fs tier's
retry-until-open, the step's NaN containment and the checkpoint chain's
resume. One supervised pass runs

    load (fs retries inside) -> begin_pass(enable_revert) [guard armed]
      -> prepare_pass -> train_pass -> health gates -> [global verdict]
      -> end_pass [confirm] -> a checkpoint publish (base or delta)

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
drops the pass, "degrade" trains it over the records that survived. In a
coordinated run the corrupt-fraction verdict rides the same allgather as
the pass and load verdicts, so every rank admits or rejects in lockstep.

Coordination (``transport=``, :class:`EpochCoordinator`). The port runs
one process a card, so every rank of a mesh is a process with its own
supervisor, and a pass must commit or revert on all of them: a trainer
whose ``plan.world > 1`` needs the host transport of its rank. Before
``end_pass`` every rank publishes a verdict (its gates passed, or its
attempt raised) on ``ctl:verdict:<key>@e<N>``; any no, or a peer that
stopped answering, is a :class:`CoordinatedAbort` on the healthy ranks.
Every rank then reverts, bumps the same pass epoch (the aborted attempt's
frames are discarded by tag) and retries in lockstep, so the retried pass
is bitwise a run that never failed. A load failure is voted on the same
way before anything is armed. The verdict rounds ride the transport, the
one control plane the JAX package has; none goes over the
``torch.distributed`` group.

A limit shared with the JAX package: a rank that raises inside a device
collective (a ``step.device`` fault mid-pass) leaves its peers waiting in
that collective until the group's timeout, and the group may be unusable
afterwards (the JAX package's peers wait in a ``psum`` alike). The
verdict exchange heals failures outside the device plane: the gates, the
load and the poison verdict.

Elastic membership (``elastic=``, :class:`ElasticConfig`): a dead peer is
a membership round, an ownership shrink and the adoption of its shards
from its durable chain, and the pass retries on the survivors; at a
published boundary a waiting joiner is admitted (``join_day`` on its
side) or skewed ranges migrate owner to owner. A survivor of a shrink
owns several mesh shards, which ``CTRTrainer``'s one process a card
cannot place (``_check_hosts``); the elastic day runs on the host plane,
as the JAX package's elastic tests and chaos probe run it.

The supervisor brings the device up through ``utils/backendguard.py``
when the trainer is on CUDA (it raises when the card never comes up). The
port compiles nothing at run time, so ``compile_cache_dir`` "auto" and
"off" do nothing.
"""

from __future__ import annotations

import json
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
from paddlebox_tpu_torch.parallel import membership as _membership
from paddlebox_tpu_torch.parallel.transport import PeerDeadError
from paddlebox_tpu_torch.train.checkpoint import MembershipEpochError, rank_root
from paddlebox_tpu_torch.utils.faultinject import InjectedFault
from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_OBSERVE, STAT_SET
from paddlebox_tpu_torch.utils.trace import PROFILER

# the incident vocabulary (each kind counted as supervisor_<kind>), and the
# kinds that lose a pass (or the day): each flushes the flight recorder
# into an incident bundle
_INCIDENT_KINDS = (
    "load_error", "prefetch_error", "data_poisoned", "ckpt_save_error", "peer_abort", "train_error",
    "escalate_resume", "gave_up", "gate_nan", "gate_auc", "rank_death", "migrate", "migrate_abort",
    "rank_join", "join_abort",
)
_FATAL_INCIDENT_KINDS = ("data_poisoned", "peer_abort", "gave_up")

# the join protocol's control tags: the announce is an un-epoched knock
# (the joiner does not know the fleet's clocks yet); the offer is addressed
# per joiner rank, so a second announcer never takes another's admission
_JOIN_ANNOUNCE_TAG = "ctl:join:announce"
_JOIN_OFFER_TAG = "ctl:join:offer"

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


class CoordinatedAbort(RuntimeError):
    """A peer voted no on this pass (its gate fired or its attempt raised),
    or the verdict exchange itself failed: this rank's healthy attempt
    reverts so that the ranks retry in lockstep."""

    def __init__(self, detail: str):
        super().__init__(f"pass aborted by peer verdict: {detail}")
        self.detail = detail


class EpochCoordinator:
    """The verdict exchange and the pass epoch of one rank.

    ``exchange_verdict`` is an allgather on ``ctl:verdict:<key>@e<N>``
    (``b"\\x01"`` yes, ``b"\\x00" + detail[:512]`` no) and returns the
    global verdict; its own transport failure or timeout is a no vote, since
    a rank that cannot hear its peers must not confirm. Ranks that
    membership confirmed dead send ``b""`` placeholders, which are no vote
    at all. ``advance`` bumps the epoch after a revert and raises the
    transport's stale-frame floor, so nothing a reverted attempt left in
    flight reaches the retry's exchanges."""

    def __init__(self, transport, timeout: Optional[float] = None):
        self.transport = transport
        self.timeout = timeout
        self.epoch = 0
        # elastic mode re-raises PeerDeadError instead of folding it into a
        # no vote: a dead peer is a membership event for the supervisor's
        # death handler, not a retryable pass failure
        self.raise_peer_dead = False

    def exchange_verdict(self, key: str, ok: bool, detail: str = "", fatal: bool = False):
        """(global_ok, detail) once every rank has voted. ``fatal=True``
        re-raises a local transport failure or timeout instead of voting
        no: at a commit point (an epoch flip) a rank that timed out cannot
        tell whether its peers committed, so it dies loudly and is shrunk
        out rather than serve the old map against their new one."""
        payload = b"\x01" if ok else b"\x00" + detail.encode()[:512]
        tag = f"ctl:verdict:{key}@e{self.epoch}"
        try:
            votes = self.transport.allgather(payload, tag, timeout=self.timeout)
        except PeerDeadError as e:
            if self.raise_peer_dead:
                raise
            STAT_ADD("supervisor_verdict_exchange_errors")
            return False, f"verdict exchange failed: {e!r}"
        except (OSError, TimeoutError) as e:
            STAT_ADD("supervisor_verdict_exchange_errors")
            if fatal:
                raise
            return False, f"verdict exchange failed: {e!r}"
        live_fn = getattr(self.transport, "live_ranks", None)
        live = set(live_fn()) if live_fn is not None else set(range(self.transport.n_ranks))
        bad = [
            f"rank {r}: {v[1:].decode(errors='replace') or 'aborted'}"
            for r, v in enumerate(votes)
            if r in live and v[:1] != b"\x01"
        ]
        if bad:
            return False, "; ".join(bad)
        return True, ""

    def advance(self, epoch: Optional[int] = None) -> None:
        """Enter the next pass epoch, or adopt the dataset's counter (which
        revert_pass bumps), keeping the two in lockstep."""
        self.epoch = self.epoch + 1 if epoch is None else epoch
        self.transport.discard_epochs_below(self.epoch)


@dataclass
class ElasticConfig:
    """Elastic membership for a coordinated supervisor.

    ``shared_root`` is the day root under which every rank publishes its
    chain (``rank-<r>``, ``checkpoint.rank_root``): an adoption reads a dead
    rank's chain through it. ``migrate_skew`` > 1 arms planned migration:
    at a confirmed boundary, when the max/mean key load a rank crosses it,
    ownership is recut and the moving ranges stream owner to owner.
    ``initial_live`` names the ranks running at day start when the
    endpoint list keeps slots for later joiners (the others are marked
    dead and ownership splits evenly over the initial set);
    ``target_ranks`` caps admissions (None admits whoever knocks);
    ``hot_migrate`` weighs the migration loads by hotness (tier residency
    and decayed shows, ``table/dist_ws.hot_shard_loads``) instead of raw
    key counts. A joiner's carve is always weighted by hotness."""

    shared_root: str
    migrate_skew: float = 0.0  # <= 1.0 disables planned migration
    adopt_retries: int = 2
    member_timeout: Optional[float] = None
    target_ranks: Optional[int] = None
    initial_live: Optional[Sequence[int]] = None
    hot_migrate: bool = False


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
    kind: str  # one of _INCIDENT_KINDS
    action: str  # retry | revert_retry | resume | raise | skip | degrade | deferred | commit
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
        elastic: Optional[ElasticConfig] = None,
    ):
        if on_give_up not in ("raise", "skip"):
            raise ValueError(f"on_give_up must be 'raise' or 'skip', got {on_give_up!r}")
        if on_poisoned not in (None, "fail", "skip_pass", "degrade"):
            raise ValueError(f"on_poisoned must be None, 'fail', 'skip_pass' or 'degrade', got {on_poisoned!r}")
        plan = getattr(trainer, "plan", None)
        if plan is not None and plan.world > 1:
            # one process a card: each mesh rank runs its own supervisor,
            # and only the verdict exchange keeps their passes in lockstep
            if transport is None:
                raise ValueError(
                    f"a supervisor over a mesh of {plan.world} ranks needs transport=, this rank's "
                    "host transport: every rank must agree on a retry through the verdict exchange"
                )
            if transport.n_ranks != plan.world or transport.rank != plan.rank:
                raise ValueError(
                    f"transport rank {transport.rank} of {transport.n_ranks} != mesh rank {plan.rank} "
                    f"of {plan.world}: the verdict exchange must span the mesh's ranks, in its order"
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
        # several ranks: the verdict exchange and the pass epoch; one rank
        # needs no coordination
        self.coord = (
            EpochCoordinator(transport)
            if transport is not None and getattr(transport, "n_ranks", 1) > 1
            else None
        )
        if self.coord is not None:
            self.coord.epoch = getattr(dataset, "pass_epoch", 0)
        # elastic membership needs the coordinator (one rank has no
        # membership to lose) and a dataset that carries an OwnershipMap
        self.elastic = elastic
        if elastic is not None and self.coord is not None:
            self.coord.raise_peer_dead = True
            tp = self.coord.transport
            if elastic.initial_live is not None:
                # the endpoint list keeps slots for later joiners: mark them
                # dead so collectives do not wait on empty slots, and split
                # ownership evenly over the running fleet
                live0 = sorted(int(r) for r in elastic.initial_live)
                if tp.rank not in live0:
                    raise ValueError(
                        f"rank {tp.rank} is not in initial_live {live0}: a rank outside the "
                        "initial fleet joins through join_day, not run_day"
                    )
                tp.mark_dead([r for r in range(tp.n_ranks) if r not in live0])
                if getattr(dataset, "ownership", None) is None:
                    dataset.ownership = _membership.OwnershipMap.even_over(dataset.n_mesh_shards, live0)
            omap0 = getattr(dataset, "ownership", None)
            STAT_SET("membership.epoch", omap0.epoch if omap0 is not None else 0)
            STAT_SET("membership.live_ranks", len(omap0.live_ranks) if omap0 is not None else tp.n_ranks)
        # set when ownership flipped mid-chain: the next save re-anchors
        # with a base (a delta must not straddle an epoch flip)
        self._force_base = False
        # the map the last flip replaced: adoption falls back to it when a
        # dead rank's chain predates the flip
        self._prev_ownership = None
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
            rank = getattr(transport, "rank", 0) if transport is not None else 0
            self.metrics = MetricsWriter(obs_dir, rank=rank)
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
        loads synchronously instead. A coordinated run does not kick: its
        load is a verdict round that stays on the pass boundary."""
        if self.coord is not None or not config.get_flag("boundary_pipeline"):
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

    def _coordinated_load(self, date: Optional[str], files: Sequence[str]) -> None:
        """The load as a verdict round: a rank whose input never came takes
        every peer down with it now, before anything is armed, instead of
        leaving them waiting in the first exchange. It votes before it
        raises."""
        while True:
            load_err: Optional[PassFailure] = None
            try:
                self._load_with_retry(date, files)
            except PassFailure as e:
                load_err = e
            try:
                ok, detail = self.coord.exchange_verdict(
                    f"load:{self._pass_seq}", load_err is None, repr(load_err) if load_err else ""
                )
            except PeerDeadError as e:
                # elastic mode only: shrink the membership and redo the
                # (unarmed) load on the survivors
                if self.elastic is None:
                    raise
                self._handle_rank_death(e)
                continue
            break
        if load_err is not None:
            raise load_err
        if not ok:
            # nothing armed yet: no revert, a clean global stop
            self._record("peer_abort", "raise", 0, detail)
            raise PassFailure(f"pass {self._pass_seq} aborted: peer load failed: {detail}")

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
        """Apply the on_poisoned policy to a global poison verdict: True
        trains the pass (degrade), False drops it (skip_pass); "fail"
        raises DataPoisonedError."""
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
        """One armed begin -> train -> gate -> [global verdict] -> confirm
        cycle."""
        err: Optional[Exception] = None
        out: Dict[str, float] = {}
        trained = None
        try:
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
            # the gates and the verdict (a revert cancels it and restores
            # the rows)
            trained = self.tr.trained_table()
            if hasattr(self.ds, "kick_writeback"):
                self.ds.kick_writeback(trained)
            self._gate(out)
        except Exception as e:
            if self.coord is None:
                raise
            # hold the failure until the verdict is out: the peers wait on
            # this rank's vote, and only a no that every rank hears aborts
            # the pass everywhere
            err = e
        if self.coord is not None:
            ok, detail = self.coord.exchange_verdict(f"pass:{self._pass_seq}", err is None, repr(err) if err else "")
            if err is not None:
                raise err
            if not ok:
                raise CoordinatedAbort(detail)
        # confirm only after the global verdict: the guard is armed up to
        # here, so every rank that must revert still can. A guard is armed,
        # so the boundary is the classic one (host rows)
        self.ds.end_pass(trained, shrink=self.shrink)
        return out

    def _revert(self, attempt: int, cause: BaseException) -> None:
        if isinstance(cause, PassRejected):
            kind = f"gate_{cause.gate}"
        elif isinstance(cause, CoordinatedAbort):
            kind = "peer_abort"
        else:
            kind = "train_error"
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
                if mode == "base" or self._force_base:
                    # an ownership flip re-anchors the chain: the old
                    # deltas cover the ranges before the flip
                    self.checkpoint.save_base(self._date, self.table, self.tr)
                    self._force_base = False
                else:
                    self.checkpoint.save_delta(self._date, self.table, self.tr)
                return
            except MembershipEpochError as e:
                # the cursor predates this rank's ownership epoch: re-anchor
                # instead of retrying the refused delta
                self._record("ckpt_save_error", "retry", attempt, repr(e))
                self._force_base = True
            except Exception as e:
                # an atomic publish leaves nothing under a final name: a
                # retry starts clean
                if attempt >= self.retry.retries:
                    self._record("ckpt_save_error", "raise", attempt, repr(e))
                    raise PassFailure(f"checkpoint {mode} save failed after {attempt + 1} attempts: {e}") from e
                self._record("ckpt_save_error", "retry", attempt, repr(e))
                self.retry.sleep(self.retry.backoff(attempt + 1))
        raise PassFailure(
            f"checkpoint {mode} save failed: retry budget spent re-anchoring across an ownership-epoch flip"
        )

    # ---- elastic membership: the shrink --------------------------------------

    def _ownership_map(self):
        """The dataset's OwnershipMap, by default the even split over all
        transport ranks at epoch 0 (as DistributedWorkingSet defaults)."""
        omap = getattr(self.ds, "ownership", None)
        if omap is None:
            omap = _membership.OwnershipMap.even(self.ds.n_mesh_shards, self.coord.transport.n_ranks)
        return omap

    def _install_ownership(self, new_map, prev_map=None) -> None:
        """Adopt a successor OwnershipMap: the dataset's routing, the
        checkpoint's epoch and the chain's re-anchor, together.

        The re-anchor base is saved here, before any pass trains under the
        new map: a rank that died mid-pass would otherwise leave a chain
        from before the flip, and adoption would restore the ranges it
        gained from the seeded init. ``prev_map`` is what this flip
        replaced (the membership round passes its synced base, so every
        survivor records the same predecessor)."""
        self._prev_ownership = prev_map if prev_map is not None else self._ownership_map()
        self.ds.ownership = new_map
        if self.checkpoint is not None:
            self.checkpoint.ownership_epoch = new_map.epoch
            self.checkpoint.live_ranks = [int(r) for r in new_map.live_ranks]
        self._force_base = True
        STAT_SET("membership.epoch", new_map.epoch)
        STAT_SET("membership.live_ranks", len(new_map.live_ranks))
        if self.checkpoint is not None and self._date is not None:
            self._save_checkpoint("base")

    def _handle_rank_death(self, e: PeerDeadError) -> None:
        """The survivors' membership change: a verdict round, a map sync,
        the shrunk map and the adoption of the dead ranks' shards from
        their durable chains. A peer that dies while the round runs is
        unioned into the dead set and the round re-runs, at most once a
        rank (each re-entry grows the set). The retried pass then runs over
        exactly the table a fresh run of the shrunk membership holds."""
        assert self.elastic is not None and self.coord is not None
        tp = self.coord.transport
        last = e
        for round_no in range(tp.n_ranks + 1):
            tp.mark_dead(last.dead)
            try:
                self._membership_round(last)
                return
            except PeerDeadError as nested:
                last = nested
                self._record("rank_death", "retry", round_no, f"peer died mid-membership-round: {nested!r}")
        raise PassFailure(
            f"membership change did not converge within {tp.n_ranks + 1} rounds; last evidence: {last!r}"
        ) from last

    def _membership_round(self, e: PeerDeadError) -> None:
        """One attempt of the membership change; raises PeerDeadError when
        another peer dies mid-round (the caller unions and re-enters)."""
        tp = self.coord.transport
        # revert what the dying attempt armed before the table is touched
        if getattr(self.ds, "_in_pass", False):
            try:
                self.ds.revert_pass()
            except Exception as re_err:
                self._record("rank_death", "revert_failed", 0, f"{e!r}; revert: {re_err!r}")
                raise PassFailure(f"revert failed after peer death {e!r}: {re_err}") from re_err
        self.coord.advance(getattr(self.ds, "pass_epoch", None))
        # every survivor converges on one dead set
        agreed = _membership.agree_membership(tp, self._pass_seq, timeout=self.elastic.member_timeout)
        # a survivor whose previous round was cut short re-enters a map
        # behind: all derive the successor from the highest-epoch base
        old_map = self._ownership_map()
        base_map = _membership.sync_map(tp, self._pass_seq, agreed, old_map, timeout=self.elastic.member_timeout)
        # adoption sources are judged against this rank's installed map: a
        # rank that missed a flip never adopted its pieces
        newly_dead = [d for d in agreed if old_map.is_live(d)]
        new_map = base_map.shrink(agreed)
        my_rank = tp.rank
        adopted_ranges = []
        for d in newly_dead:
            dlo, dhi = old_map.range_of(d)
            mlo, mhi = new_map.range_of(my_rank)
            lo, hi = max(dlo, mlo), min(dhi, mhi)
            if lo < hi:
                adopted_ranges.append([lo, hi])
        # adoption retries in isolation: the pass must not retry under a
        # half-installed map
        adopt_err: Optional[Exception] = None
        adopted_keys = 0
        for a in range(self.elastic.adopt_retries + 1):
            try:
                adopted_keys = sum(
                    _membership.adopt_dead_shards(
                        self.table, self.elastic.shared_root, d, old_map, new_map, my_rank,
                        prev_map=self._prev_ownership,
                    )
                    for d in newly_dead
                )
                adopt_err = None
                break
            except Exception as ae:
                adopt_err = ae
                if a < self.elastic.adopt_retries:
                    self._record("rank_death", "retry", a, repr(ae))
                    self.retry.sleep(self.retry.backoff(a + 1))
        # every survivor adopts before anyone re-enters the pass, and one
        # failing aborts all; the tag carries the successor's epoch and
        # fingerprint, so divergent maps stall loudly instead of committing
        ok, detail = self.coord.exchange_verdict(
            f"member:{self._pass_seq}:{new_map.epoch}:{new_map.fingerprint()}",
            adopt_err is None,
            repr(adopt_err) if adopt_err else "",
        )
        if adopt_err is not None:
            self._record("rank_death", "raise", 0, repr(adopt_err))
            raise PassFailure(
                f"shard adoption failed after {self.elastic.adopt_retries + 1} attempts: {adopt_err}"
            ) from adopt_err
        if not ok:
            self._record("rank_death", "raise", 0, detail)
            raise PassFailure(f"peer shard adoption failed: {detail}")
        self._install_ownership(new_map, prev_map=base_map)
        self._record(
            "rank_death", "revert_retry", 0,
            f"dead={list(agreed)} survivors={list(new_map.live_ranks)} "
            f"ownership_epoch={new_map.epoch} adopted_keys={adopted_keys}",
        )
        bundle = {
            "dead": [int(d) for d in agreed],
            "survivors": [int(r) for r in new_map.live_ranks],
            "ownership_epoch": new_map.epoch,
            "adopted_ranges": adopted_ranges,
            "adopted_keys": int(adopted_keys),
        }
        FLIGHT_RECORDER.note_incident("membership_change", bundle)
        FLIGHT_RECORDER.dump("rank_death", json.dumps(bundle), dir_path=self._incident_dir)
        PROFILER.instant("supervisor:membership_change", bundle)

    # ---- elastic membership: planned migration -------------------------------

    def _gather_shard_loads(self, omap, hot: bool, tag: str) -> np.ndarray:
        """Allgather the global load a mesh shard under ``omap``: each live
        rank sends its owned slice as little-endian float64, raw key counts
        (``hot=False``) or weighted by hotness (``hot_shard_loads``). Every
        rank derives the same plan from the same vector."""
        from paddlebox_tpu_torch.table.sparse_table import key_to_shard

        tp = self.coord.transport
        # planners read host rows: whatever a carried table owes lands first
        drain = getattr(self.table, "drain_pending", None)
        if drain is not None:
            drain()
        lo, hi = omap.range_of(tp.rank)
        if hot:
            from paddlebox_tpu_torch.table.dist_ws import hot_shard_loads

            local = hot_shard_loads(self.table, omap, tp.rank)
        else:
            keys = self.table.keys()
            sh = key_to_shard(keys, omap.n_mesh_shards)
            mine = sh[(sh >= lo) & (sh < hi)]
            local = np.bincount(mine - lo, minlength=hi - lo).astype(np.float64)
        views = tp.allgather(local.astype("<f8").tobytes(), tag, timeout=self.elastic.member_timeout)
        loads = np.zeros(omap.n_mesh_shards, np.float64)
        for r in omap.live_ranks:
            rlo, rhi = omap.range_of(r)
            v = views[r]
            if len(v) != (rhi - rlo) * 8:
                # never recut from a zero-filled view: every rank would
                # derive the same wrong plan
                STAT_ADD("membership.load_view_errors")
                raise RuntimeError(
                    f"load view from rank {r} has {len(v)} bytes, expected "
                    f"{(rhi - rlo) * 8} for shard range [{rlo},{rhi})"
                )
            loads[rlo:rhi] = np.frombuffer(v, dtype="<f8")
        return loads

    def _maybe_migrate(self) -> None:
        """Planned migration at a confirmed boundary: recut ownership when
        the key-load skew crosses the threshold and stream the moving
        ranges owner to owner. Receivers stage, a commit verdict decides,
        and only a global yes flips the epoch; any failure leaves the old
        epoch serving and the plan is derived again at the next boundary."""
        assert self.elastic is not None and self.coord is not None
        tp = self.coord.transport
        omap = self._ownership_map()
        if len(omap.live_ranks) < 2:
            return
        loads = self._gather_shard_loads(
            omap, self.elastic.hot_migrate, f"ctl:load:{self._pass_seq}@e{self.coord.epoch}"
        )
        new_map = _membership.plan_rebalance(omap, loads, self.elastic.migrate_skew)
        if new_map is None:
            # every rank derived None from the same vector: no round needed
            return
        seq = f"{self._pass_seq}.{new_map.epoch}"
        xfer = None
        xfer_err: Optional[Exception] = None
        try:
            xfer = _membership.migrate_ranges(
                tp, self.table, omap, new_map, seq, self.coord.epoch, timeout=self.elastic.member_timeout
            )
        except Exception as me:
            xfer_err = me
        # the commit verdict is atomic (fatal=True): a rank whose round
        # timed out cannot tell whether its peers committed, so it dies
        # with PassFailure and the survivors shrink it out
        try:
            ok, detail = self.coord.exchange_verdict(
                f"migrate:{seq}:{new_map.fingerprint()}",
                xfer_err is None,
                repr(xfer_err) if xfer_err else "",
                fatal=True,
            )
        except PeerDeadError:
            raise  # a dead peer is decidable: the membership handler owns it
        except (OSError, TimeoutError) as ve:
            STAT_ADD("membership.migrations_aborted")
            self._record("migrate_abort", "raise", 0, repr(ve))
            raise PassFailure(f"migrate commit verdict uncertain (transport failure mid-round): {ve!r}") from ve
        if not ok or xfer_err is not None:
            # the old epoch serves on; the staged pieces are dropped
            STAT_ADD("membership.migrations_aborted")
            self._record("migrate_abort", "retry", 0, detail or repr(xfer_err))
            return
        _membership.commit_staged(self.table, xfer["staged"])
        self._install_ownership(new_map)
        STAT_ADD("membership.migrated_keys", int(xfer["recv_keys"]))
        STAT_ADD("membership.migration_bytes", int(xfer["sent_bytes"]))
        self._record(
            "migrate", "commit", 0,
            f"ownership_epoch={new_map.epoch} moves={xfer['moves']} "
            f"recv_keys={xfer['recv_keys']} sent_bytes={xfer['sent_bytes']}",
        )
        FLIGHT_RECORDER.note_incident(
            "migration",
            {
                "ownership_epoch": new_map.epoch,
                "moves": xfer["moves"],
                "recv_keys": int(xfer["recv_keys"]),
                "sent_bytes": int(xfer["sent_bytes"]),
            },
        )

    def _boundary_elastic(self, publishing: bool) -> None:
        """One elastic action a confirmed boundary: admit a waiting joiner
        (when the chain it catches up from is published), else consider a
        planned migration. An admission already recut ownership, so the
        next boundary weighs the skew under the grown map."""
        admitted = False
        if publishing:
            admitted = self._maybe_admit_joiner()
        if not admitted and self.elastic.migrate_skew > 1.0:
            self._maybe_migrate()

    # ---- elastic membership: the grow half, the fleet's side -----------------

    def _maybe_admit_joiner(self) -> bool:
        """Scan for knocks from ranks that are not live, converge on one
        joiner and run its admission. The scan rides an allgather and
        admits only what every live rank saw: a knock still in flight to a
        peer admits at the next boundary. True when a joiner committed."""
        assert self.elastic is not None and self.coord is not None
        tp = self.coord.transport
        omap = self._ownership_map()
        pend = tp.pending_sources(_JOIN_ANNOUNCE_TAG)
        waiting = [int(r) for r in pend if not omap.is_live(r)]
        # consume the counted knocks: a waiting joiner knocks again every
        # few hundred ms, and unconsumed frames must not pile up
        for r in pend:
            while r in tp.pending_sources(_JOIN_ANNOUNCE_TAG):
                tp.recv(_JOIN_ANNOUNCE_TAG, r, timeout=1.0)
        views = tp.allgather(
            json.dumps(waiting).encode(),
            f"ctl:joinscan:{self._pass_seq}@e{self.coord.epoch}",
            timeout=self.elastic.member_timeout,
        )
        common: Optional[set] = None
        for r in omap.live_ranks:
            seen = set(json.loads(views[r].decode() or "[]"))
            common = seen if common is None else (common & seen)
        if not common:
            return False
        if self.elastic.target_ranks is not None and len(omap.live_ranks) >= self.elastic.target_ranks:
            # at the autoscale target: announcers keep waiting
            return False
        return self._admit_joiner(min(common), omap)

    def _admit_joiner(self, joiner: int, omap) -> bool:
        """The fleet's side of one admission. Hot loads are gathered over
        the live set, the successor map carves the joiner its cuts, the
        lowest live rank sends the offer, and the ceding flanks stream
        their ranges through the staged ``migrate_ranges``. The joiner
        dying mid-round aborts at the old epoch; a survivor dying aborts
        and re-raises, so the caller's death handler shrinks."""
        tp = self.coord.transport
        loads = self._gather_shard_loads(omap, True, f"ctl:jload:{self._pass_seq}@e{self.coord.epoch}")
        new_map = omap.grow(joiner, loads)
        planned = [
            [int(lo), int(hi)] for lo, hi, _src, dst in _membership.plan_moves(omap, new_map) if dst == joiner
        ]
        seq = f"{self._pass_seq}.{new_map.epoch}"
        # readmit before any collective that counts the joiner's slot (after
        # the load gather: mark_alive keeps the link's seq space)
        tp.mark_alive(joiner)
        if tp.rank == min(omap.live_ranks):
            # one sponsor hands the joiner both maps, the day and pass
            # clocks and the pass epoch its frames must carry
            offer = {
                "old_map": omap.to_json(),
                "new_map": new_map.to_json(),
                "date": self._date,
                "pass_seq": self._pass_seq,
                "pass_epoch": self.coord.epoch,
            }
            tp.send(joiner, f"{_JOIN_OFFER_TAG}:{joiner}", json.dumps(offer).encode())
        join_err: Optional[Exception] = None
        xfer = None
        try:
            xfer = _membership.migrate_ranges(
                tp, self.table, omap, new_map, seq, self.coord.epoch, timeout=self.elastic.member_timeout
            )
        except Exception as me:
            join_err = me
        try:
            ok, detail = self.coord.exchange_verdict(
                f"join:{seq}:{new_map.fingerprint()}",
                join_err is None,
                repr(join_err) if join_err else "",
                fatal=True,
            )
        except PeerDeadError as e:
            tp.mark_dead([joiner])
            if set(int(d) for d in e.dead) <= {int(joiner)}:
                # only the joiner died: the fleet never grew, no shrink
                self._join_abort(joiner, new_map, planned, f"joiner died mid-join: {e!r}")
                return False
            # a survivor died: abort the join, the caller shrinks
            self._join_abort(joiner, new_map, planned, repr(e))
            raise
        except (OSError, TimeoutError) as ve:
            self._join_abort(joiner, new_map, planned, repr(ve))
            raise PassFailure(f"join commit verdict uncertain (transport failure mid-round): {ve!r}") from ve
        if not ok or join_err is not None:
            # receivers only staged: the old epoch serves on bitwise and
            # the joiner may knock again
            tp.mark_dead([joiner])
            self._join_abort(joiner, new_map, planned, detail if join_err is None else repr(join_err))
            return False
        _membership.commit_staged(self.table, xfer["staged"])
        self._install_ownership(new_map, prev_map=omap)
        STAT_ADD("membership.joins_total")
        self._record(
            "rank_join", "commit", 0,
            f"joiner={int(joiner)} ownership_epoch={new_map.epoch} "
            f"planned_ranges={planned} sent_keys={xfer['sent_keys']}",
        )
        bundle = {
            "joiner": int(joiner),
            "live": [int(r) for r in new_map.live_ranks],
            "ownership_epoch": int(new_map.epoch),
            "planned_ranges": planned,
            "sent_keys": int(xfer["sent_keys"]),
        }
        FLIGHT_RECORDER.note_incident("rank_join", bundle)
        PROFILER.instant("supervisor:rank_join", bundle)
        return True

    def _join_abort(self, joiner: int, new_map, planned, reason) -> None:
        """What a failed or refused admission leaves: nothing committed,
        the fleet at the old epoch, and an incident bundle naming the
        joiner, the ranges it would have taken, the epoch that never
        happened and why."""
        bundle = {
            "joiner": int(joiner),
            "planned_ranges": [[int(lo), int(hi)] for lo, hi in planned],
            "ownership_epoch": int(new_map.epoch),
            "reason": str(reason),
        }
        STAT_ADD("membership.joins_aborted")
        self._record("join_abort", "retry", 0, json.dumps(bundle))
        FLIGHT_RECORDER.note_incident("join_abort", bundle)
        FLIGHT_RECORDER.dump("join_abort", json.dumps(bundle), dir_path=self._incident_dir)
        PROFILER.instant("supervisor:join_abort", bundle)

    # ---- elastic membership: the grow half, the joiner's side ----------------

    def _announce_join(self) -> None:
        """Knock on every possible sponsor (fault site
        ``membership.join_announce``: a failed knock is retried). Peers
        that are down are expected: the joiner does not know who is live."""
        tp = self.coord.transport
        _fault_fire("membership.join_announce")
        for dst in range(tp.n_ranks):
            if dst == tp.rank or tp.is_marked_dead(dst):
                continue
            try:
                tp.send(dst, _JOIN_ANNOUNCE_TAG, b"")
            except (ConnectionError, OSError):
                continue

    def _await_offer(self, deadline: float) -> Optional[Dict[str, Any]]:
        """Knock (again every ~250 ms) until a sponsor's offer comes; None
        at the deadline. Every queued offer is consumed and the newest
        wins: an offer of an earlier aborted round must not shadow the
        live one."""
        tp = self.coord.transport
        tag = f"{_JOIN_OFFER_TAG}:{tp.rank}"
        last_announce = -1.0
        while True:
            now = time.monotonic()
            if now >= deadline:
                return None
            if now - last_announce >= 0.25:
                self._announce_join()
                last_announce = now
            payload = None
            srcs = tp.pending_sources(tag)
            while srcs:
                for s in srcs:
                    payload = tp.recv(tag, s, timeout=1.0)
                srcs = tp.pending_sources(tag)
            if payload is not None:
                return json.loads(payload.decode())
            time.sleep(0.02)

    def _catch_up(self, old_map, new_map) -> Dict[str, Any]:
        """Rebuild the gained ranges from the ceding owners' published
        chains through the Follower's CRC-verified apply. Returns each
        piece's (keys, rows) in ``plan_moves`` order, aligned with what
        ``migrate_ranges`` stages, and the ceding owners' decay clock.
        Fires ``membership.catchup_apply`` once a ceding source."""
        from paddlebox_tpu_torch.serve.follower import apply_published_chain
        from paddlebox_tpu_torch.table.sparse_table import HostSparseTable, key_to_shard

        me = self.coord.transport.rank
        pieces = [(lo, hi, src) for lo, hi, src, dst in _membership.plan_moves(old_map, new_map) if dst == me]
        scratches: Dict[int, Any] = {}
        decay_epochs = 0
        keys_by_piece: List[np.ndarray] = []
        rows_by_piece: List[np.ndarray] = []
        for lo, hi, src in pieces:
            if src not in scratches:
                _fault_fire("membership.catchup_apply")
                scratch = HostSparseTable(self.table.layout, self.table.opt, n_shards=self.table.n_shards)
                state = apply_published_chain(rank_root(self.elastic.shared_root, src), scratch)
                if state is None:
                    raise RuntimeError(
                        f"ceding rank {src} has no published chain under {self.elastic.shared_root!r}: "
                        "cannot catch up"
                    )
                scratches[src] = scratch
                decay_epochs = max(decay_epochs, getattr(scratch, "decay_epochs", 0))
            scratch = scratches[src]
            keys = np.sort(scratch.keys())
            sh = key_to_shard(keys, old_map.n_mesh_shards)
            sel = keys[(sh >= lo) & (sh < hi)]
            keys_by_piece.append(sel)
            rows_by_piece.append(
                scratch.pull_or_create(sel) if len(sel) else np.zeros((0, self.table.layout.width), np.float32)
            )
        return {
            "keys_by_piece": keys_by_piece,
            "rows_by_piece": rows_by_piece,
            "decay_epochs": int(decay_epochs),
            "keys": int(sum(len(k) for k in keys_by_piece)),
        }

    def _verify_catchup(self, catchup: Dict[str, Any], staged) -> None:
        """Chain against wire, bitwise: at a published boundary the ceding
        owner's chain is its table, so the rows rebuilt from disk must be
        the rows streamed, or the join aborts."""
        if len(staged) != len(catchup["keys_by_piece"]):
            raise RuntimeError(
                f"catch-up derived {len(catchup['keys_by_piece'])} pieces but the transfer staged {len(staged)}"
            )
        for i, (mkeys, mrows) in enumerate(staged):
            ckeys = catchup["keys_by_piece"][i]
            crows = catchup["rows_by_piece"][i]
            if not (np.array_equal(mkeys, ckeys) and np.array_equal(mrows, crows)):
                raise RuntimeError(
                    f"catch-up/transfer divergence on piece {i}: the published chain and the live "
                    f"migration disagree ({len(ckeys)} chain keys vs {len(mkeys)} wire keys)"
                )

    def _join_attempt(self, offer: Dict[str, Any]) -> bool:
        """One admission from a sponsor's offer, on the joiner: take the
        fleet's clocks, mark the ranks the successor says are dead, catch
        up from the published chains, receive the staged transfer, check
        the two bitwise and vote. Once the offer is taken this rank must
        vote (the peers wait on its slot), so every local failure is a no."""
        tp = self.coord.transport
        me = tp.rank
        old_map = _membership.OwnershipMap.from_json(offer["old_map"])
        new_map = _membership.OwnershipMap.from_json(offer["new_map"])
        # the verdict tags are scoped by pass_seq and pass epoch
        self._pass_seq = int(offer["pass_seq"])
        self._date = offer["date"]
        epoch = int(offer["pass_epoch"])
        self.coord.epoch = epoch
        if hasattr(self.ds, "pass_epoch"):
            self.ds.pass_epoch = epoch
        tp.discard_epochs_below(epoch)
        dead = [r for r in range(tp.n_ranks) if r != me and not new_map.is_live(r)]
        if dead:
            tp.mark_dead(dead)
        seq = f"{self._pass_seq}.{new_map.epoch}"
        planned = [[int(lo), int(hi)] for lo, hi, _src, dst in _membership.plan_moves(old_map, new_map) if dst == me]
        join_err: Optional[Exception] = None
        xfer = None
        catchup = None
        try:
            catchup = self._catch_up(old_map, new_map)
            xfer = _membership.migrate_ranges(
                tp, self.table, old_map, new_map, seq, epoch, timeout=self.elastic.member_timeout
            )
            self._verify_catchup(catchup, xfer["staged"])
        except Exception as e:
            # a dead ceding peer too: the peers still wait on this vote
            join_err = e
        try:
            ok, detail = self.coord.exchange_verdict(
                f"join:{seq}:{new_map.fingerprint()}",
                join_err is None,
                repr(join_err) if join_err else "",
                fatal=True,
            )
        except PeerDeadError as e:
            # the fleet lost a rank mid-round: it shrinks and offers again
            tp.mark_dead(e.dead)
            self._record("join_abort", "retry", 0, f"sponsor fleet lost a rank: {e!r}")
            return False
        except (OSError, TimeoutError) as ve:
            raise PassFailure(f"join commit verdict uncertain (transport failure mid-round): {ve!r}") from ve
        if not ok or join_err is not None:
            self._join_abort(me, new_map, planned, detail if join_err is None else repr(join_err))
            return False
        _membership.commit_staged(self.table, xfer["staged"])
        if catchup["decay_epochs"] and not getattr(self.table, "decay_epochs", 0):
            # the carved rows keep their previous owner's decay clock
            self.table.decay_epochs = catchup["decay_epochs"]
        self._install_ownership(new_map, prev_map=old_map)
        STAT_ADD("membership.joins_total")
        self._record(
            "rank_join", "commit", 0,
            f"joiner={me} ownership_epoch={new_map.epoch} "
            f"recv_keys={xfer['recv_keys']} catchup_keys={catchup['keys']}",
        )
        bundle = {
            "joiner": int(me),
            "live": [int(r) for r in new_map.live_ranks],
            "ownership_epoch": int(new_map.epoch),
            "planned_ranges": planned,
            "recv_keys": int(xfer["recv_keys"]),
            "catchup_keys": int(catchup["keys"]),
        }
        FLIGHT_RECORDER.note_incident("rank_join", bundle)
        PROFILER.instant("supervisor:rank_join", bundle)
        return True

    def join_day(
        self,
        pass_files: Sequence[Sequence[str]],
        n_batches: Optional[int] = None,
        publish: bool = True,
        timeout: float = 60.0,
    ) -> List[Optional[Dict[str, float]]]:
        """The joiner's day, the grow dual of ``run_day``: knock, take a
        sponsor's offer, catch up from the ceding owners' published chains,
        receive the carved ranges, vote in the fingerprint-tagged commit,
        re-anchor a base, then run the day's remaining passes in lockstep
        with the fleet. An aborted admission leaves the fleet at the old
        epoch and this rank knocks again; ``timeout`` bounds the wait.
        Saves are deltas: the admission re-anchored a base at the new
        epoch."""
        if self.elastic is None or self.coord is None:
            raise ValueError("join_day requires elastic mode and a coordinated transport")
        deadline = time.monotonic() + timeout
        while True:
            if time.monotonic() >= deadline:
                raise PassFailure(f"rank {self.coord.transport.rank} was not admitted within {timeout:.1f}s")
            try:
                offer = self._await_offer(deadline)
                if offer is None:
                    continue
                if self._join_attempt(offer):
                    break
            except InjectedFault as e:
                # an injected announce or catch-up fault is retryable
                self._record("join_abort", "retry", 0, repr(e))
            self.retry.sleep(0.01)
        outs: List[Optional[Dict[str, float]]] = []
        do_save = publish and self.checkpoint is not None
        for p in range(self._pass_seq, len(pass_files)):
            files = pass_files[p]
            nxt = (self._date, tuple(pass_files[p + 1])) if p + 1 < len(pass_files) else None
            outs.append(
                self.run_pass(
                    files, date=self._date, n_batches=n_batches, save="delta" if do_save else None, prefetch=nxt
                )
            )
            try:
                self._boundary_elastic(do_save)
            except PeerDeadError as e:
                self._handle_rank_death(e)
            if self.metrics is not None:
                self.metrics.maybe_snapshot()
        return outs

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
        if self.coord is None:
            self._adopt_prefetch(date, files)
        else:
            self._coordinated_load(date, files)
        # poisoned data is deterministic: resolved before the retry loop;
        # coordinated, the verdict rides the same allgather, so every rank
        # admits or rejects in lockstep
        rep = self._poison_report()
        poisoned = rep is not None and rep["poisoned"]
        poison_detail = rep["detail"] if poisoned else ""
        if self.coord is not None and rep is not None:
            ok, gdetail = self.coord.exchange_verdict(f"poison:{self._pass_seq}", not poisoned, poison_detail)
            if not ok and not poisoned:
                poisoned = True
                poison_detail = f"peer pass data poisoned: {gdetail}"
        if poisoned and not self._handle_poisoned(poison_detail, rep):
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
            except PeerDeadError as e:
                if self.elastic is None or self.coord is None:
                    # without elastic membership a lost host ends the day
                    raise
                # a membership event: shrink, adopt, then retry the pass on
                # the survivors with a fresh budget
                self._handle_rank_death(e)
                attempt = 0
                escalated = False
                continue
            except Exception as e:
                self._revert(attempt, e)
                if self.coord is not None:
                    # revert_pass bumped ds.pass_epoch: adopt it and purge
                    # the aborted attempt's frames
                    self.coord.advance(getattr(self.ds, "pass_epoch", None))
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
        ``publish=False`` trains without checkpointing. Elastic, each
        confirmed boundary may admit a joiner or migrate ranges."""
        outs: List[Optional[Dict[str, float]]] = []
        do_save = publish and self.checkpoint is not None
        for p, files in enumerate(pass_files):
            mode = None if not do_save else ("base" if p == 0 else "delta")
            nxt = (date, tuple(pass_files[p + 1])) if p + 1 < len(pass_files) else None
            outs.append(self.run_pass(files, date=date, n_batches=n_batches, save=mode, prefetch=nxt))
            if self.elastic is not None and self.coord is not None:
                try:
                    self._boundary_elastic(do_save)
                except PeerDeadError as e:
                    # a rank died in the boundary round: the next pass runs
                    # on the survivors
                    self._handle_rank_death(e)
            if self.metrics is not None:
                self.metrics.maybe_snapshot()
        return outs
