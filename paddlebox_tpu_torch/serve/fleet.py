"""Serving fleet: a networked front-end, shared staging, health and drain gossip.

Port of the JAX package's ``serve/fleet.py``. Three pieces ride the PBTX v3
framed transport (``parallel/transport.py``: CRC'd frames, sequence numbers
and replay on reconnect, heartbeats, the wire codec); there is no RPC layer
of its own, and the tags and the response header are the JAX package's byte
for byte, so a JAX front-end and port followers share one world:

- :class:`FleetStage` mirrors the published base+delta chain from the
  origin root into a host-local ``fleet_stage_dir`` once a watermark
  advance. The followers of a host tail the stage, so the origin is read
  once a publish. The stage watermark is written (atomically) only after
  every link is mirrored and CRC-checked, so a torn stage fetch never
  surfaces a partial version (fault site ``serve.fleet_stage``).

- :class:`FleetFollower` wraps a :class:`Follower` and a
  :class:`ScoreServer` behind a transport rank: a request loop answers
  ``serve:req`` with ``serve:resp``, a gossip loop beats
  ``ctl:serve:health`` (state, chain position, staleness, queue depth),
  and ``ctl:serve:drain`` flips the drain protocol (finish in-flight,
  refuse new with a typed refusal, announce by gossip). Its scoring runs
  on its ``device`` (``cuda`` by default): the batcher thread sets the
  card and scores on a stream of the follower's own, so followers sharing
  one card do not serialise on the default stream.

- :class:`FleetClient` is the load-balancing front-end: it routes each
  request to a queryable follower (a lagging, re-anchoring, draining or
  silent follower is marked and skipped), enforces per-request deadlines,
  retries with bounded exponential backoff on a different follower, and
  hedges: when the primary has not answered within ``serve_hedge_ms`` the
  request goes to a second follower and the first answer wins.

Load shedding lives in ScoreServer.submit (a typed
:class:`ServeOverloadError` past ``serve_shed_queue_depth``); a corrupt or
torn publish never takes a follower out of rotation: it serves its last
good version and the view marks it at most "lagging".
"""

from __future__ import annotations

import json
import logging
import os
import queue
import shutil
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.data.parser import parse_line
from paddlebox_tpu_torch.obs.histogram import Histogram
from paddlebox_tpu_torch.serve.follower import Follower, verify_chain_link
from paddlebox_tpu_torch.serve.server import (
    ScoreServer,
    Scorer,
    ServeOverloadError,
    ServeTimeoutError,
)
from paddlebox_tpu_torch.train.checkpoint import (
    _file_crc32,
    read_watermark,
    validate_watermark,
)
from paddlebox_tpu_torch.utils.device import DeviceLike
from paddlebox_tpu_torch.utils.faultinject import fire
from paddlebox_tpu_torch.utils.fs import atomic_write
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_OBSERVE, STAT_SET

logger = logging.getLogger(__name__)

# PBTX tags of the serve plane, the JAX package's: serve:req / serve:resp
# are the front-end framing (data plane), ctl:serve:* the control gossip
_REQ_TAG = "serve:req"
_RESP_TAG = "serve:resp"
_HEALTH_TAG = "ctl:serve:health"
_DRAIN_TAG = "ctl:serve:drain"

# response frame: id, status, delta_idx, n — then n float32 preds (OK)
# or a utf-8 detail message (any refusal/error status)
_RESP = struct.Struct("<QBiI")
_ST_OK = 0
_ST_OVERLOAD = 1
_ST_DRAINING = 2
_ST_ERROR = 3
_ST_TIMEOUT = 4
_ST_NAMES = {
    _ST_OK: "ok",
    _ST_OVERLOAD: "overload",
    _ST_DRAINING: "draining",
    _ST_ERROR: "error",
    _ST_TIMEOUT: "timeout",
}


class ServeRequestError(RuntimeError):
    """The fleet client exhausted its deadline/retry budget without one
    OK answer. Carries the per-attempt refusals for the postmortem."""

    def __init__(self, msg: str, rejects: List[Tuple[int, str, str]]):
        super().__init__(msg)
        self.rejects = rejects  # (follower rank, status name, detail)


# ---- host-local shared staging ---------------------------------------------


class FleetStage:
    """Mirror the origin's published chain into ``fleet_stage_dir`` once.

    ``stage_once`` is idempotent: links already mirrored and CRC-clean are
    skipped, a half-copied link from a previous torn attempt is replaced,
    and the stage's own ``latest.json`` is published (atomically) only
    after the whole chain verifies — followers tailing the stage can never
    observe a partial version. One stager serves any number of followers:
    ``serve.fleet_stage_fetches`` counts mirrored snapshots, independent
    of fleet size (the "single disk fetch" claim, pinned by tests).
    """

    def __init__(self, origin_root: str, stage_dir: Optional[str] = None):
        self.origin = origin_root
        self.stage_dir = stage_dir or str(config.get_flag("fleet_stage_dir"))
        if not self.stage_dir:
            raise ValueError(
                "FleetStage needs a stage directory: pass stage_dir or set "
                "the fleet_stage_dir flag"
            )
        os.makedirs(self.stage_dir, exist_ok=True)
        self.require_manifest = bool(config.get_flag("serve_require_manifest"))

    # -- internals ---------------------------------------------------------

    def _mirror_snapshot(self, rel: str, want_crc) -> bool:
        """Copy one snapshot dir origin -> stage; returns True when bytes
        moved. Present-and-verified links are skipped (idempotent retry);
        a stale/torn copy is replaced wholesale."""
        dst = os.path.join(self.stage_dir, rel)
        if os.path.isdir(dst) and verify_chain_link(
            self.stage_dir, rel, want_crc, self.require_manifest
        ):
            return False
        tmp = os.path.join(self.stage_dir, rel + ".staging")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        os.makedirs(os.path.dirname(tmp) or self.stage_dir, exist_ok=True)
        shutil.copytree(os.path.join(self.origin, rel), tmp)
        os.replace(tmp, dst)
        if not verify_chain_link(self.stage_dir, rel, want_crc, self.require_manifest):
            raise RuntimeError(
                f"staged snapshot {rel!r} failed CRC verification after "
                "mirror — origin bytes changed mid-copy or disk fault"
            )
        return True

    def _mirror_dense(self, wm: Dict[str, Any]) -> bool:
        dense = wm.get("dense")
        if dense is None:
            return False
        rel, want = dense["path"], dense.get("crc32")
        dst = os.path.join(self.stage_dir, rel)
        if os.path.exists(dst) and (want is None or _file_crc32(dst) == want):
            return False
        src = os.path.join(self.origin, rel)
        if not os.path.exists(src):
            return False  # follower's own dense-skip alarm handles it
        os.makedirs(os.path.dirname(dst) or self.stage_dir, exist_ok=True)
        tmp = dst + ".staging"
        shutil.copyfile(src, tmp)
        if want is not None and _file_crc32(tmp) != want:
            raise RuntimeError(
                f"staged dense file {rel!r} failed CRC after mirror"
            )
        os.replace(tmp, dst)
        return True

    # -- public surface ----------------------------------------------------

    def stage_once(self) -> bool:
        """One origin poll; returns True when the stage watermark advanced.

        Raises on any mirror fault (including the injected
        ``serve.fleet_stage`` site) — the caller's loop counts and
        retries; the stage watermark is only written on full success, so
        followers never see a partial chain.
        """
        wm = read_watermark(self.origin)
        if wm is None:
            return False
        validate_watermark(wm)
        if read_watermark(self.stage_dir) == wm:
            return False  # stage is current
        fire("serve.fleet_stage")
        idx = int(wm["delta_idx"])
        fetched = 0
        fetched += self._mirror_snapshot(
            wm["base"]["path"], wm["base"].get("manifest_crc")
        )
        for entry in wm["deltas"][:idx]:
            fetched += self._mirror_snapshot(
                entry["path"], entry.get("manifest_crc")
            )
        fetched += self._mirror_dense(wm)
        with atomic_write(os.path.join(self.stage_dir, "latest.json")) as f:
            json.dump(wm, f)
        if fetched:
            STAT_ADD("serve.fleet_stage_fetches", fetched)
        STAT_SET("serve.fleet_stage_delta_idx", idx)
        return True

    def run(self, stop: threading.Event, interval_s: Optional[float] = None) -> None:
        """Stager loop with alarm-and-keep-staging semantics (same contract
        as Follower.run: a bad origin publish must not kill the host)."""
        interval = (
            config.get_flag("serve_poll_interval_s")
            if interval_s is None
            else interval_s
        )
        while not stop.is_set():
            try:
                self.stage_once()
            except Exception as e:  # noqa: BLE001 — staging must outlive faults
                STAT_ADD("serve.fleet_stage_errors")
                logger.error(
                    "fleet stage fetch failed (stage watermark unchanged, "
                    "followers keep serving last staged version): %s", e,
                )
            stop.wait(interval)


# ---- follower-side: request serving + gossip -------------------------------


class FleetFollower:
    """One serving rank: a Follower + ScoreServer behind PBTX framing.

    Threads: a request loop (recv ``serve:req`` → answer queue), a small
    answer pool (waits on the batcher future, sends ``serve:resp``), a
    health-gossip loop, and (optionally) the follower's own poll loop.
    ``drain``/``admit`` commands arrive on ``ctl:serve:drain`` and are
    handled inside the request loop, so drain state and request admission
    are ordered by construction.
    """

    _N_ANSWERERS = 4

    def __init__(
        self,
        transport,
        client_rank: int,
        follower: Follower,
        scorer: Scorer,
        schema,
        poll_interval_s: Optional[float] = None,
        device: DeviceLike = "cuda",
    ):
        self.tp = transport
        self.client_rank = int(client_rank)
        self.follower = follower
        self.schema = schema
        # the server checks that its device is the scorer's
        self.server = ScoreServer(follower, scorer, schema, device=device)
        self.device = self.server.device
        self._stream = None
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._inflight = 0  # guarded-by: _iflock
        self._iflock = threading.Lock()
        self._work: "queue.Queue[Optional[dict]]" = queue.Queue()
        self._threads: List[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self, poll: bool = True) -> None:
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
        # the server's batcher is the one thread that scores: it runs on
        # this follower's card and stream
        self.server._thread = threading.Thread(target=self._batcher_on_device, name="fleet-batcher", daemon=True)
        self.server._thread.start()
        targets = [self._request_loop, self._health_loop] + [
            self._answer_loop
        ] * self._N_ANSWERERS
        if poll:
            targets.append(
                lambda: self.follower.run(self._stop, self.poll_interval_s)
            )
        for fn in targets:
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for _ in range(self._N_ANSWERERS):
            self._work.put(None)
        for t in self._threads:
            t.join(timeout=10)
        self.server.stop()

    def _batcher_on_device(self) -> None:
        if self._stream is None:
            self.server._batcher()
            return
        torch.cuda.set_device(self.device)
        with torch.cuda.stream(self._stream):
            self.server._batcher()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def inflight(self) -> int:
        with self._iflock:
            return self._inflight

    # -- request path ------------------------------------------------------

    def _request_loop(self) -> None:
        while not self._stop.is_set():
            self._poll_drain()
            try:
                payload = self.tp.recv(_REQ_TAG, self.client_rank, timeout=0.2)
            except TimeoutError:
                continue
            except ConnectionError:
                # client link down (incl. PeerDeadError) — keep serving,
                # the front-end reconnects or a new one dials in
                STAT_ADD("serve.request_loop_errors")
                self._stop.wait(0.2)
                continue
            try:
                fire("serve.request_recv")
                req = json.loads(payload.decode("utf-8"))
                rid = int(req["id"])
            except Exception as e:  # noqa: BLE001 — a lost request is the client's retry
                STAT_ADD("serve.request_recv_errors")
                logger.error("serve request dropped at recv: %s", e)
                continue
            if self._draining.is_set():
                STAT_ADD("serve.drain_refused")
                self._reply(rid, _ST_DRAINING, detail="follower draining")
                continue
            with self._iflock:
                self._inflight += 1
            self._work.put(req)

    def _answer_loop(self) -> None:
        while True:
            req = self._work.get()
            if req is None:
                return
            try:
                self._answer(req)
            finally:
                with self._iflock:
                    self._inflight -= 1

    def _answer(self, req: dict) -> None:
        rid = int(req["id"])
        budget_s = max(0.0, float(req.get("deadline_ms", 0.0))) / 1000.0 or None
        try:
            records = [parse_line(ln, self.schema) for ln in req["lines"]]
            pending = self.server.submit(records)
            preds = pending.result(budget_s)
        except ServeOverloadError as e:
            self._reply(rid, _ST_OVERLOAD, detail=str(e))
            return
        except ServeTimeoutError as e:
            self._reply(rid, _ST_TIMEOUT, detail=str(e))
            return
        except Exception as e:  # noqa: BLE001 — typed on the wire, client retries
            STAT_ADD("serve.request_errors")
            self._reply(rid, _ST_ERROR, detail=repr(e))
            return
        self._reply(rid, _ST_OK, delta_idx=pending.delta_idx, preds=preds)

    def _reply(
        self,
        rid: int,
        status: int,
        delta_idx: int = -1,
        preds: Optional[np.ndarray] = None,
        detail: str = "",
    ) -> None:
        if status == _ST_OK:
            body = np.asarray(preds, dtype=np.float32).tobytes()
            n = len(preds)
        else:
            body = detail.encode("utf-8")
            n = 0
        try:
            self.tp.send(
                self.client_rank,
                _RESP_TAG,
                _RESP.pack(rid, status, delta_idx, n) + body,
            )
            STAT_ADD("serve.fleet_responses")
        except (ConnectionError, OSError) as e:
            # client gone mid-request: its retry/hedge already covers this
            STAT_ADD("serve.response_send_errors")
            logger.error("serve response %s dropped: %s", rid, e)

    # -- drain protocol ----------------------------------------------------

    def _poll_drain(self) -> None:
        if self.client_rank not in self.tp.pending_sources(_DRAIN_TAG):
            return
        try:
            payload = self.tp.recv(_DRAIN_TAG, self.client_rank, timeout=1.0)
        except (TimeoutError, ConnectionError):
            STAT_ADD("serve.drain_errors")
            return
        try:
            fire("serve.drain")
            action = json.loads(payload.decode("utf-8"))["action"]
        except Exception as e:  # noqa: BLE001 — dropped command, client re-sends
            STAT_ADD("serve.drain_errors")
            logger.error("drain command dropped (client will re-send): %s", e)
            return
        if action == "drain":
            if not self._draining.is_set():
                self._draining.set()
                STAT_ADD("serve.drains")
                logger.info("follower draining: finishing in-flight, refusing new")
        elif action == "admit":
            if self._draining.is_set():
                self._draining.clear()
                STAT_ADD("serve.drain_admits")
                logger.info("follower re-admitted to rotation")
        # announce the (possibly unchanged — idempotent) state right away
        self._beat()

    # -- health gossip -----------------------------------------------------

    def _state(self) -> str:
        snap = self.follower.health_snapshot()
        if self._draining.is_set():
            if self.inflight() == 0 and self.server.queue_depth() == 0:
                return "drained"
            return "draining"
        if not snap["warm"]:
            return "cold"
        if snap["reanchoring"]:
            return "reanchor"
        return "ready"

    def _beat(self) -> None:
        beat = dict(self.follower.health_snapshot())
        beat["state"] = self._state()
        beat["queue_depth"] = self.server.queue_depth()
        beat["inflight"] = self.inflight()
        try:
            self.tp.send(
                self.client_rank, _HEALTH_TAG, json.dumps(beat).encode("utf-8")
            )
            STAT_ADD("serve.health_beats")
        except (ConnectionError, OSError):
            STAT_ADD("serve.health_beat_errors")

    def _health_loop(self) -> None:
        interval = float(config.get_flag("serve_health_beat_s"))
        while not self._stop.is_set():
            self._beat()
            self._stop.wait(interval)


# ---- client-side: health view + load balancing -----------------------------


class FleetView:
    """Per-follower health bookkeeping, fed by ctl:serve:health beats.

    ``status`` is the follower-health state machine:
    never/dead (no or stale gossip), cold (no served params yet),
    draining/drained (explicit drain protocol), reanchor (mid ownership-
    epoch re-anchor, or an epoch behind the fleet), lagging (delta_idx
    more than ``serve_lag_deltas`` behind the freshest same-epoch
    follower), penalized (recent refusal/send failure, short cooldown),
    ready (queryable). Only "ready" followers are routed to.
    """

    def __init__(self, ranks: Sequence[int]):
        self.ranks = [int(r) for r in ranks]
        self._lock = threading.Lock()
        self._beats: Dict[int, dict] = {}  # guarded-by: _lock
        self._t_beat: Dict[int, float] = {}  # guarded-by: _lock
        self._penalty_until: Dict[int, float] = {}  # guarded-by: _lock
        self._drain_intent: set = set()  # guarded-by: _lock
        self._rr = 0  # guarded-by: _lock
        # (epoch, delta_idx, staleness_s) per rank, appended whenever the
        # gossiped chain position advances — the staleness gauge tests pin
        # monotone-per-version on this log
        self.staleness_log: Dict[int, List[Tuple[int, int, float]]] = {}

    def observe(self, rank: int, beat: dict) -> None:
        rank = int(rank)
        with self._lock:
            prev = self._beats.get(rank)
            self._beats[rank] = beat
            self._t_beat[rank] = time.monotonic()
            pos = (int(beat.get("ownership_epoch", 0)), int(beat.get("delta_idx", -1)))
            if beat.get("staleness_s") is not None and (
                prev is None
                or (int(prev.get("ownership_epoch", 0)),
                    int(prev.get("delta_idx", -1))) < pos
            ):
                self.staleness_log.setdefault(rank, []).append(
                    (pos[0], pos[1], float(beat["staleness_s"]))
                )
        STAT_SET("serve.fleet_queryable", len(self.queryable()))

    def set_drain_intent(self, rank: int, draining: bool) -> None:
        """Operator intent: marked out of rotation immediately, before the
        follower's own gossip confirms."""
        with self._lock:
            if draining:
                self._drain_intent.add(int(rank))
            else:
                self._drain_intent.discard(int(rank))

    def penalize(self, rank: int, seconds: float) -> None:
        with self._lock:
            self._penalty_until[int(rank)] = max(
                self._penalty_until.get(int(rank), 0.0),
                time.monotonic() + seconds,
            )

    # -- status ------------------------------------------------------------

    def _statuses(self) -> Dict[int, str]:
        """One consistent pass over every rank under one lock hold (the
        lock is non-reentrant, so all guarded reads live here)."""
        dead_s = float(config.get_flag("serve_health_dead_s"))
        lag_deltas = int(config.get_flag("serve_lag_deltas"))
        with self._lock:
            now = time.monotonic()
            fresh = [
                r for r in self.ranks
                if r in self._t_beat and now - self._t_beat[r] <= dead_s
            ]
            epochs = [int(self._beats[r].get("ownership_epoch", 0)) for r in fresh]
            emax = max(epochs) if epochs else 0
            dmax = max(
                (
                    int(self._beats[r].get("delta_idx", -1))
                    for r in fresh
                    if int(self._beats[r].get("ownership_epoch", 0)) == emax
                ),
                default=-1,
            )
            out: Dict[int, str] = {}
            for rank in self.ranks:
                if rank in self._drain_intent:
                    out[rank] = "draining"
                    continue
                t = self._t_beat.get(rank)
                if t is None:
                    out[rank] = "never"
                    continue
                if now - t > dead_s:
                    out[rank] = "dead"
                    continue
                b = self._beats[rank]
                state = b.get("state", "ready")
                if state in ("draining", "drained"):
                    out[rank] = state
                elif state == "cold" or not b.get("warm"):
                    out[rank] = "cold"
                elif state == "reanchor" or b.get("reanchoring"):
                    out[rank] = "reanchor"
                elif int(b.get("ownership_epoch", 0)) < emax:
                    # behind an ownership-epoch flip the rest of the fleet
                    # already applied: out of rotation until its own
                    # re-anchor lands
                    out[rank] = "reanchor"
                elif int(b.get("delta_idx", -1)) < dmax - lag_deltas:
                    out[rank] = "lagging"
                elif now < self._penalty_until.get(rank, 0.0):
                    out[rank] = "penalized"
                else:
                    out[rank] = "ready"
            return out

    def status(self, rank: int) -> str:
        return self._statuses()[int(rank)]

    def queryable(self) -> List[int]:
        statuses = self._statuses()
        return [r for r in self.ranks if statuses[r] == "ready"]

    def pick(self, avoid: Sequence[int] = ()) -> Optional[int]:
        """Round-robin over queryable followers, preferring ones not in
        ``avoid``; falls back to an avoided-but-queryable one rather than
        failing (retrying the same follower beats not retrying).

        With ``serve_lb_least_loaded`` on, the round-robin choice is
        weighed against the NEXT rotation candidate by the queue depth
        each follower last gossiped (least-loaded-of-two: near-uniform
        spread when depths tie, hot-spot avoidance when they don't);
        taking the second candidate over the rotation's own is counted
        under ``serve.lb_rerouted``. Flag off is the pure round-robin
        ablation, bitwise the historical pick order."""
        q = self.queryable()
        if not q:
            return None
        preferred = [r for r in q if r not in set(avoid)] or q
        with self._lock:
            self._rr += 1
            first = preferred[self._rr % len(preferred)]
            if len(preferred) < 2 or not config.get_flag(
                "serve_lb_least_loaded"
            ):
                return first
            second = preferred[(self._rr + 1) % len(preferred)]
            b1 = self._beats.get(first)
            b2 = self._beats.get(second)
            d1 = 0 if b1 is None else int(b1.get("queue_depth", 0))
            d2 = 0 if b2 is None else int(b2.get("queue_depth", 0))
            if d2 < d1:
                STAT_ADD("serve.lb_rerouted")
                return second
            return first

    def snapshot(self) -> Dict[int, str]:
        return self._statuses()

    def gossip_state(self, rank: int) -> Optional[str]:
        """The state the follower ITSELF last gossiped (None before any
        beat). Unlike :meth:`status` this ignores the operator's drain
        intent — it is the drain protocol's confirmation signal, so it
        must reflect only what the follower announced."""
        with self._lock:
            b = self._beats.get(int(rank))
            return None if b is None else b.get("state")


class _ClientPending:
    """One in-flight client request: outcomes from every dispatched copy
    (primary + hedge + retries share the request id)."""

    def __init__(self) -> None:
        self.cv = threading.Condition()
        self.ok: Optional[dict] = None  # guarded-by: cv
        self.rejects: List[Tuple[int, str, str]] = []  # guarded-by: cv
        self.dispatched = 0  # guarded-by: cv

    def add(self, src: int, status: int, resp: dict) -> bool:
        """Record one response; returns False for a duplicate OK (a lost
        hedge race)."""
        with self.cv:
            if status == _ST_OK:
                if self.ok is not None:
                    return False
                self.ok = resp
            else:
                self.rejects.append(
                    (src, _ST_NAMES.get(status, str(status)), resp.get("detail", ""))
                )
            self.cv.notify_all()
            return True

    def wait(self, deadline: float) -> Optional[dict]:
        """Block until an OK lands, every dispatched copy has been
        rejected, or ``deadline`` (monotonic). Returns the OK or None."""
        with self.cv:
            while True:
                if self.ok is not None:
                    return self.ok
                if self.dispatched and len(self.rejects) >= self.dispatched:
                    return None
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self.cv.wait(min(left, 0.1))


class FleetClient:
    """Load-balancing, deadline-enforcing, hedging front-end client.

    One response thread and one gossip thread multiplex ALL followers via
    ``recv_first`` — responses carry the request id, so hedged duplicates
    and post-deadline stragglers resolve (or are counted away) without
    any per-follower thread fan-out.
    """

    def __init__(self, transport, follower_ranks: Sequence[int], schema=None):
        self.tp = transport
        self.ranks = [int(r) for r in follower_ranks]
        self.schema = schema
        self.view = FleetView(self.ranks)
        self.latency_hist = Histogram()
        self._lock = threading.Lock()
        self._pending: Dict[int, _ClientPending] = {}  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._marked_dead: set = set()  # ranks we confirmed dead to the transport

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        for fn in (self._resp_loop, self._gossip_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def _sync_membership(self) -> None:
        """Mirror the health view into transport membership: a follower
        whose gossip went silent is confirmed dead to the transport, which
        is what arms the HELLO delivered-count reset — without it a NEW
        incarnation rejoining at the same rank would have all its frames
        eaten as replay duplicates of the old stream."""
        statuses = self.view.snapshot()
        for rank, status in statuses.items():
            if status == "dead" and rank not in self._marked_dead:
                self._marked_dead.add(rank)
                self.tp.mark_dead([rank])
                STAT_ADD("serve.fleet_deaths")
                logger.warning("follower %s confirmed dead (gossip silent)", rank)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)

    # -- receive loops -----------------------------------------------------

    def _resp_loop(self) -> None:
        while not self._stop.is_set():
            try:
                src, payload = self.tp.recv_first(_RESP_TAG, self.ranks, timeout=0.2)
            except TimeoutError:
                continue
            except ConnectionError:
                # every follower dead by the detector — keep polling, a
                # rejoin resets last_seen and the fleet comes back
                self._stop.wait(0.2)
                continue
            rid, status, delta_idx, n = _RESP.unpack_from(payload)
            body = payload[_RESP.size:]
            if status == _ST_OK:
                resp = {
                    "src": src,
                    "delta_idx": int(delta_idx),
                    "preds": np.frombuffer(body, dtype=np.float32, count=n).copy(),
                }
            else:
                resp = {"src": src, "detail": body.decode("utf-8", "replace")}
            with self._lock:
                pending = self._pending.get(rid)
            if pending is None:
                STAT_ADD("serve.late_responses")
                continue
            if not pending.add(src, status, resp):
                STAT_ADD("serve.hedge_wasted")

    def _gossip_loop(self) -> None:
        while not self._stop.is_set():
            try:
                src, payload = self.tp.recv_first(_HEALTH_TAG, self.ranks, timeout=0.2)
            except TimeoutError:
                self._sync_membership()
                continue
            except ConnectionError:
                self._stop.wait(0.2)
                continue
            try:
                beat = json.loads(payload.decode("utf-8"))
            except ValueError:
                STAT_ADD("serve.health_beat_errors")
                continue
            if src in self._marked_dead:
                # gossip resumed from a rank we confirmed dead: a new
                # incarnation joined at that slot — readmit it
                self._marked_dead.discard(src)
                self.tp.mark_alive(src)
                STAT_ADD("serve.fleet_rejoins")
                logger.info("follower %s rejoined (gossip resumed)", src)
            self.view.observe(src, beat)
            self._sync_membership()

    # -- request path ------------------------------------------------------

    def _register(self) -> Tuple[int, _ClientPending]:
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            pending = _ClientPending()
            self._pending[rid] = pending
            return rid, pending

    def _unregister(self, rid: int) -> None:
        with self._lock:
            self._pending.pop(rid, None)

    def _dispatch(self, rank: int, pending: _ClientPending, payload: bytes) -> bool:
        try:
            self.tp.send(rank, _REQ_TAG, payload)
        except (ConnectionError, OSError) as e:
            STAT_ADD("serve.client_send_errors")
            self.view.penalize(rank, 1.0)
            logger.warning("dispatch to follower %s failed: %s", rank, e)
            return False
        with pending.cv:
            pending.dispatched += 1
        return True

    def score_lines(
        self, lines: Sequence[str], timeout: Optional[float] = None
    ) -> Tuple[np.ndarray, dict]:
        """Score raw slot-format lines; returns (preds, meta) with
        ``meta["delta_idx"]``/``meta["src"]``. Deadline, bounded-backoff
        retry across followers, and hedged re-dispatch all live here; the
        typed :class:`ServeRequestError` surfaces only after the whole
        budget is spent."""
        if timeout is None:
            timeout = float(config.get_flag("serve_request_timeout_ms")) / 1000.0
        retries = int(config.get_flag("serve_client_retries"))
        backoff = float(config.get_flag("serve_client_backoff_s"))
        hedge_s = float(config.get_flag("serve_hedge_ms")) / 1000.0
        t0 = time.monotonic()
        t_end = t0 + timeout
        rid, pending = self._register()
        STAT_ADD("serve.client_requests")
        avoid: set = set()
        hedges = 0
        try:
            for attempt in range(retries + 1):
                if attempt:
                    STAT_ADD("serve.client_retries")
                    delay = min(
                        backoff * (2 ** (attempt - 1)),
                        max(0.0, t_end - time.monotonic()),
                    )
                    if delay > 0:
                        time.sleep(delay)
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    break
                target = self.view.pick(avoid=avoid)
                if target is None:
                    # no queryable follower right now — burn a retry slot
                    # waiting for gossip to readmit one
                    continue
                payload = json.dumps({
                    "id": rid,
                    "deadline_ms": remaining * 1000.0,
                    "lines": list(lines),
                }).encode("utf-8")
                if not self._dispatch(target, pending, payload):
                    avoid.add(target)
                    continue
                wait_until = (
                    t_end if hedge_s <= 0
                    else min(t_end, time.monotonic() + hedge_s)
                )
                ok = pending.wait(wait_until)
                if ok is None and hedge_s > 0 and time.monotonic() < t_end:
                    with pending.cv:
                        answered = pending.dispatched <= len(pending.rejects)
                    if not answered:
                        # primary silent past the hedge budget: race a
                        # second follower, first answer wins
                        second = self.view.pick(avoid=avoid | {target})
                        if second is not None and second != target:
                            if self._dispatch(second, pending, payload):
                                hedges += 1
                                STAT_ADD("serve.hedges")
                    ok = pending.wait(t_end)
                if ok is not None:
                    lat_ms = (time.monotonic() - t0) * 1000.0
                    self.latency_hist.observe(lat_ms)
                    STAT_OBSERVE("serve.client_latency_ms", lat_ms)
                    return ok["preds"], {
                        "src": ok["src"],
                        "delta_idx": ok["delta_idx"],
                        "latency_ms": lat_ms,
                        "attempts": attempt + 1,
                        "hedges": hedges,
                    }
                # every dispatched copy refused (or deadline loomed):
                # penalize refusers briefly and go around
                with pending.cv:
                    rejects = list(pending.rejects)
                for src, _name, _detail in rejects:
                    avoid.add(src)
                    self.view.penalize(src, 0.5)
            STAT_ADD("serve.client_failures")
            with pending.cv:
                rejects = list(pending.rejects)
            raise ServeRequestError(
                f"score request {rid} failed after {retries + 1} attempts "
                f"within {timeout:.1f}s (rejections: "
                f"{[(s, n) for s, n, _ in rejects]})",
                rejects,
            )
        finally:
            self._unregister(rid)

    # -- drain orchestration ----------------------------------------------

    def _drain_cmd(
        self, rank: int, action: str, confirm_states: Tuple[str, ...],
        wait_s: float,
    ) -> bool:
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            try:
                self.tp.send(
                    rank, _DRAIN_TAG,
                    json.dumps({"action": action}).encode("utf-8"),
                )
                STAT_ADD("serve.drain_commands")
            except (ConnectionError, OSError):
                STAT_ADD("serve.client_send_errors")
            # commands are idempotent: re-send until the follower's OWN
            # gossip confirms (a dropped command — e.g. the serve.drain
            # fault site — heals on the next lap)
            confirm_by = min(deadline, time.monotonic() + 0.5)
            while time.monotonic() < confirm_by:
                if self.view.gossip_state(rank) in confirm_states:
                    return True
                time.sleep(0.02)
        return False

    def drain(self, rank: int, wait_s: float = 10.0) -> bool:
        """Explicit drain: mark out of rotation NOW, then command the
        follower (finish in-flight, refuse new) and wait for its gossip
        to announce the drain. Idempotent; returns confirmation."""
        self.view.set_drain_intent(rank, True)
        return self._drain_cmd(rank, "drain", ("draining", "drained"), wait_s)

    def admit(self, rank: int, wait_s: float = 10.0) -> bool:
        """Readmit a drained follower to rotation (confirmed by gossip).
        The operator mark is lifted first — until the follower's own beat
        stops saying "draining" the view still keeps it out, so routing
        only resumes once BOTH sides agree."""
        self.view.set_drain_intent(rank, False)
        return self._drain_cmd(rank, "admit", ("ready", "cold", "reanchor"), wait_s)

    # -- reporting ---------------------------------------------------------

    def latency_percentiles(self) -> dict:
        h = self.latency_hist
        if h.count == 0:
            return {"n": 0}
        p50, p99 = h.quantiles((0.5, 0.99))
        return {
            "n": h.count,
            "p50_ms": float(p50),
            "p99_ms": float(p99),
            "max_ms": float(h.max),
        }
