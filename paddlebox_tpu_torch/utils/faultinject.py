"""Deterministic fault injection for the pass/day robustness loop.

The reference earns its multi-day soak claims through recovery machinery
(Confirm/Revert on the PS tables fleet_wrapper.h:319-321, retry-until-open
on transiently missing inputs data_feed.cc:2738-2740, base+delta publishing
a restarted job resumes from). Those mechanisms are only as trustworthy as
the failure harness that exercises them — so this module gives every
recovery seam a *named injection site* that tests can arm with seeded,
counted triggers and tear down hermetically.

Catalog of wired sites (see docs/ROBUSTNESS.md for the recovery matrix):

    fs.open_read            utils/fs.py  fs_open_read / fs_read_bytes_retry
    fs.open_write           utils/fs.py  fs_open_write
    fs.atomic_write         utils/fs.py  atomic_write: after tmp-file write,
                            before the os.replace publish (its own site so
                            arming it never shifts fs.open_write hit counts)
    pipeline.prefetch_job   data/pipeline.py  each prefetch job execution
    checkpoint.save         train/checkpoint.py  each durability boundary
                            inside save_base/save_delta (multiple fires per
                            save — hit counts select a crash window)
    checkpoint.load         train/checkpoint.py  resume(): before base load
                            and before each delta apply
    step.device             train/trainer.py  before each device-step (or
                            superstep) dispatch
    transport.connect       parallel/transport.py  before each outbound
                            connection attempt (first connect AND every
                            reconnect, so a rule can keep a link down)
    transport.send          parallel/transport.py  before each wire attempt
                            of a data frame — an injected failure exercises
                            the retained-frame reconnect/resend path
    transport.recv_frame    parallel/transport.py  top of each reader-loop
                            frame iteration; a failure drops the connection
                            receiver-side (sender resyncs via heartbeat)
    transport.heartbeat     parallel/transport.py  before each peer beat —
                            suppressing beats starves acks and the peer's
                            failure detector
    wire.host_decode        parallel/transport.py  reader loop, before a
                            codec-framed (PBTX v3) payload is inflated —
                            an injected failure is a corrupt-after-CRC
                            decode: the connection dies pre-delivery and
                            the sender's resync replays the frame
                            exactly once
    boundary.premerge       data/dataset.py  boundary feed stage, before the
                            staged working set's key premerge (pipelined
                            boundary only)
    boundary.stage_pull     data/dataset.py  boundary feed stage, before the
                            host pull_or_create prefetch for the staged
                            next pass
    boundary.writeback      data/dataset.py  top of the end_pass_async
                            worker, before writeback/decay — a failure here
                            exercises the saved-state restore + pass reopen
    parser.parse_line       data/parser.py  top of parse_line, before each
                            text-line parse (the Python tier and the
                            native-fallback re-parse both route through it)
                            — an injected failure is a synthetic corrupt
                            line: quarantined in data_quarantine mode,
                            fatal to the load in strict mode
    data.file_read          data/dataset.py  _read_one, before each part
                            file is opened/read — an injected failure is a
                            synthetic unreadable file (quarantined whole in
                            data_quarantine mode)
    backend.init            utils/backendguard.py  before each subprocess
                            CUDA-init probe — an injected failure is a
                            simulated wedged device, exercising the
                            watchdog, the retries and the typed error
                            (there is no CPU fallback)
    serve.apply_delta       serve/scoring_table.py  commit(): after the next
                            scoring-table version is fully built, before the
                            atomic swap — a failure is a follower crash
                            mid-apply; the served version must remain the
                            previous complete one (no partial delta is ever
                            visible to score requests)
    spill.io                table/sparse_table.py  spill_cold, before the
                            native cap sweep — an injected failure is a
                            disk-tier write error: surfaced as the typed
                            SpillIOError and counted under
                            table.spill_errors (the end_pass worker's
                            failure path then reopens the pass for retry)
    spill.stage_flush       table/sparse_table.py  spill_cold, after spill.io
                            — models the double-buffered stage writer's
                            fwrite handoff dying mid-sweep (native rc -2
                            from the flusher thread) as its own site, so
                            arming it never shifts spill.io hit counts;
                            surfaced as SpillIOError, counted under
                            table.spill_errors
    table.writeback_worker  table/sparse_table.py  push_writeback, before
                            each writer-pool chunk of the end-of-pass
                            writeback — an injected failure is a worker rc
                            error: surfaced as SpillIOError through the
                            chunked writeback, the boundary worker's
                            failure path reopens the pass, and the
                            supervisor's revert restores pre-pass rows
                            bitwise before the retry
    membership.adopt_shard  parallel/membership.py  adopt_dead_shards,
                            after the dead rank's checkpoint shard is
                            resumed but before its keys are pushed into
                            the survivor's table — a failure is a crash
                            mid-adoption; the retry re-runs the same
                            CRC-verified resume and the push is a pure
                            upsert, so the retried adoption lands
                            bitwise-identical
    migrate.transfer        parallel/membership.py  migrate_ranges, on the
                            sender before a shard range is encoded onto
                            the wire — a failure aborts the planned
                            migration; the verdict round then keeps the
                            OLD ownership epoch serving (stale-epoch
                            frames are unreceivable) and the plan is
                            simply retried at the next pass boundary
    wire.ici_pack           data/device_pack.py  _route_sharded, before the
                            hot-first bucket ordering of the adaptive ICI
                            wire (fires only when the working set carries
                            hotness bits) — a failure degrades that batch
                            to the uniform slot order: hot keys ride the
                            int8 region (correct values, just
                            un-prioritized precision), counted under
                            wire.ici_pack_errors
    membership.join_announce  train/supervisor.py  _announce_join, before
                            the joiner knocks on the fleet's sponsors — a
                            failure means the announce never went out;
                            nothing durable moved, the joiner simply
                            knocks again (join_day's retry loop)
    membership.catchup_apply  train/supervisor.py  _catch_up, once per
                            ceding source before its published base+delta
                            chain is applied into the joiner's scratch —
                            a failure folds into the joiner's NO vote on
                            the join verdict: the fleet stays at the OLD
                            ownership epoch bitwise (receivers only
                            staged, nothing committed) and a retried join
                            succeeds (FLT008 recovery contract)
    serve.request_recv      serve/fleet.py  front-end request loop, after a
                            score-request frame is consumed off the wire
                            and before it is decoded/handed to the batcher
                            — an injected failure is a request lost inside
                            the serving host: counted under
                            serve.request_recv_errors, the loop keeps
                            serving, and the CLIENT's bounded-backoff
                            retry (same request id) succeeds
    serve.fleet_stage       serve/fleet.py  FleetStage.stage_once, after a
                            new origin watermark is seen and before any
                            chain link is mirrored into fleet_stage_dir —
                            a failure is a torn host-local stage fetch:
                            the stage watermark never advances (followers
                            keep serving the last staged version; no
                            partial version is ever visible) and the next
                            stage poll retries the same mirror
                            idempotently
    serve.drain             serve/fleet.py  drain-command handling, after
                            a ctl:serve:drain frame is consumed and
                            before the follower flips its drain state —
                            a failure drops the command: counted under
                            serve.drain_errors, the follower stays in its
                            previous state, and the client re-sends until
                            the health gossip confirms (drain/admit are
                            idempotent)
    serve.tier_build        serve/scoring_table.py  build_device_tier, at
                            the start of the device hot-tier build inside
                            commit() — a failure models a follower dying
                            mid-tier-build: the commit aborts before the
                            swap so no partial tier (and no new version)
                            is ever visible, the old version keeps
                            serving bitwise, and the healed retry commits
                            the same version+tier bitwise
                            (tests/test_serve_shard.py pins it)
    stream.tail_read        train/stream.py  DirectoryTailer.poll, before
                            each append-only file's new byte range is read
                            — an injected failure is an unreadable tail
                            chunk: the file's cursor position does not
                            advance (counted under stream.tail_read_errors)
                            and the next poll re-reads the SAME bytes, so
                            a transient read flake never drops a record
    stream.cut_publish      train/stream.py  StreamSupervisor._cut, twice
                            per micro-pass cut (hit counts select a crash
                            window): after the cut intent + spool are
                            durable but before the pass trains/publishes,
                            and after the delta published but before the
                            stream cursor commits — the recovery contract
                            is exactly-once: a restart replays the durable
                            spool when the delta never published, and
                            rolls the cursor forward without retraining
                            when it did (zero records lost or replayed,
                            tests/test_stream.py pins both windows)
    ckpt.compact            train/checkpoint.py  CheckpointManager.compact,
                            three windows (nothing read yet / chain folded
                            into the scratch table but unpublished /
                            compact dir published but cursor stale) — a
                            crash in ANY window leaves the old base+delta
                            chain untouched and fully servable bitwise
                            (the compact dir publishes via the same
                            tmp+rename discipline as every snapshot), and
                            the healed retry folds the same chain bitwise

A site fires via :func:`fire`; when no plan is installed that is a single
global read, so production paths pay nothing. Tests install a
:class:`FaultPlan` through the :func:`inject` context manager:

    with inject(fail_nth("fs.open_read", 1)):          # flake once, heal
        ...

Triggers compose per rule: ``nth`` fails one specific hit, ``prob`` fails
each hit with probability p under a fixed seed, and ``times`` bounds how
many failures a rule deals before going inert (``times=1`` is
fail-once-then-heal). All counters are plan-scoped, so a test's schedule
can never leak into the next test.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

# The declared site catalog. fire()/fail_* against a name NOT listed here is
# a silent no-op waiting to happen — pbox-lint REG003 cross-checks every
# literal site string in the package against this tuple.
KNOWN_SITES = (
    "fs.open_read",
    "fs.open_write",
    "fs.atomic_write",
    "pipeline.prefetch_job",
    "checkpoint.save",
    "checkpoint.load",
    "step.device",
    "transport.connect",
    "transport.send",
    "transport.recv_frame",
    "transport.heartbeat",
    "wire.host_decode",
    "boundary.premerge",
    "boundary.stage_pull",
    "boundary.writeback",
    "parser.parse_line",
    "data.file_read",
    "backend.init",
    "serve.apply_delta",
    "spill.io",
    "spill.stage_flush",
    "table.writeback_worker",
    "membership.adopt_shard",
    "migrate.transfer",
    "wire.ici_pack",
    "membership.join_announce",
    "membership.catchup_apply",
    "serve.request_recv",
    "serve.fleet_stage",
    "serve.drain",
    "serve.tier_build",
    "stream.tail_read",
    "stream.cut_publish",
    "ckpt.compact",
)


class InjectedFault(OSError):
    """Deterministic injected failure.

    Subclasses OSError on purpose: the fs retry tier (``_retry_open``)
    treats OSError as transient, so an injected flake exercises exactly
    the production retry path.
    """

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at site {site!r} (hit {hit})")
        self.site = site
        self.hit = hit


@dataclass
class FaultRule:
    """One trigger bound to one site.

    ``nth``    1-based hit index (counted from plan install) that fails.
    ``prob``   iid failure probability per hit, drawn from ``seed``.
    ``times``  failure budget before the rule heals (None = unlimited).
    ``exc``    optional factory ``(site, hit) -> BaseException``.
    """

    site: str
    nth: Optional[int] = None
    prob: float = 0.0
    seed: int = 0
    times: Optional[int] = 1
    exc: Optional[Callable[[str, int], BaseException]] = None
    _rng: np.random.Generator = field(init=False, repr=False)
    _fired: int = field(default=0, init=False, repr=False)

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def should_fail(self, hit: int) -> bool:
        if self.times is not None and self._fired >= self.times:
            return False
        if self.nth is not None and hit == self.nth:
            return True
        # the draw happens on every hit the budget allows, so a schedule's
        # failure positions depend only on (seed, hit sequence)
        if self.prob > 0.0 and self._rng.random() < self.prob:
            return True
        return False

    def make_exc(self, hit: int) -> BaseException:
        self._fired += 1
        if self.exc is not None:
            return self.exc(self.site, hit)
        return InjectedFault(self.site, hit)


class FaultPlan:
    """An installed set of rules + per-site hit/failure counters."""

    def __init__(self, rules: List[FaultRule]):
        self._rules: Dict[str, List[FaultRule]] = {}
        for r in rules:
            self._rules.setdefault(r.site, []).append(r)
        self._hits: Dict[str, int] = {}
        self._failures: Dict[str, int] = {}
        # sites fire from worker threads (prefetch pool, end_pass_async
        # publisher), so counter state must be serialized
        self._lock = threading.Lock()

    def hit(self, site: str) -> None:
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
            for rule in self._rules.get(site, ()):
                if rule.should_fail(n):
                    self._failures[site] = self._failures.get(site, 0) + 1
                    exc = rule.make_exc(n)
                    break
            else:
                return
        from paddlebox_tpu_torch.utils.monitor import STAT_ADD

        STAT_ADD("faults_injected")
        raise exc

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def failures(self, site: str) -> int:
        with self._lock:
            return self._failures.get(site, 0)


_active: Optional[FaultPlan] = None
_install_lock = threading.Lock()


def fire(site: str) -> None:
    """Injection-site hook. No-op (one global read) when nothing is armed."""
    plan = _active
    if plan is not None:
        plan.hit(site)


@contextmanager
def inject(*rules: FaultRule) -> Iterator[FaultPlan]:
    """Install ``rules`` for the dynamic extent of the block (hermetic:
    the previous plan — usually none — is restored on exit, even on
    error). Yields the plan so tests can read hit/failure counters."""
    global _active
    plan = FaultPlan(list(rules))
    with _install_lock:
        prev, _active = _active, plan
    try:
        yield plan
    finally:
        with _install_lock:
            _active = prev


def fail_nth(
    site: str,
    n: int,
    times: Optional[int] = 1,
    exc: Optional[Callable[[str, int], BaseException]] = None,
) -> FaultRule:
    """Fail exactly the ``n``-th hit of ``site`` (1-based, counted from
    plan install)."""
    return FaultRule(site=site, nth=n, times=times, exc=exc)


def fail_once(
    site: str, exc: Optional[Callable[[str, int], BaseException]] = None
) -> FaultRule:
    """Fail the first hit, then heal — the canonical transient flake."""
    return fail_nth(site, 1, times=1, exc=exc)


def fail_always(
    site: str,
    times: Optional[int] = None,
    exc: Optional[Callable[[str, int], BaseException]] = None,
) -> FaultRule:
    """Fail every hit (until ``times`` failures, if set) — a persistent
    outage rather than a flake."""
    return FaultRule(site=site, prob=1.0, times=times, exc=exc)


def fail_prob(
    site: str,
    p: float,
    seed: int = 0,
    times: Optional[int] = None,
    exc: Optional[Callable[[str, int], BaseException]] = None,
) -> FaultRule:
    """Fail each hit with probability ``p`` under a fixed seed; ``times``
    caps the total failures (None = every drawn hit fails)."""
    return FaultRule(site=site, prob=p, seed=seed, times=times, exc=exc)
