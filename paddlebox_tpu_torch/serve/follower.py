"""Pull-only checkpoint follower: tails latest.json, applies delta chains.

Port of the JAX package's ``serve/follower.py``. The consumer half of the
online loop: the trainer publishes base + per-pass deltas
(``CheckpointManager``) and a serving replica pulls them; there is no
connection back into the training job, only a shared checkpoint root.
Each poll:

1. reads the ``latest.json`` watermark (an atomic publish, so a read sees
   a whole watermark or the previous one),
2. validates the lineage (:func:`validate_watermark`, plus rewind
   detection -> :class:`DeltaLineageError`; a new base or date triggers a
   full reload),
3. CRC-verifies every snapshot it is about to consume (the manifest CRC
   the watermark pins, then the per-file manifest check): a corrupt delta
   is skipped with an alarm stat and the follower keeps serving the last
   good version,
4. applies the verified links into a private staging ``HostSparseTable``
   (the same load/apply_delta code the trainer's resume uses, so the
   decay-epoch catch-up is bitwise the trainer's own),
5. commits each applied link to the :class:`ScoringTable` as an atomic
   version swap, with the dense params paired with the chain head, loaded
   through a ``CTRTrainer``'s ``load_dense``.

Preds served from the committed version are bitwise equal to scoring
directly against the trainer's table and params at the same pass. With
the ``device_scoring_tier`` flag on, each commit passes the staging
table's decayed shows as ``hotness``, so the version carries a device
scoring tier on the follower's ``device`` (``serve/scoring_table.py``;
on a host without a GPU the commit raises unless ``device="cpu"``), and
:meth:`Follower.health_snapshot` reports its rows, hits and misses.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.serve.scoring_table import ScoringTable, TableVersion, TierDevices
from paddlebox_tpu_torch.table.sparse_table import HostSparseTable
from paddlebox_tpu_torch.train.checkpoint import (
    DeltaLineageError,
    _file_crc32,
    _manifest_crc,
    read_watermark,
    validate_watermark,
    verify_snapshot,
)
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_OBSERVE, STAT_SET

logger = logging.getLogger(__name__)


def verify_chain_link(
    root: str, rel: str, want_crc, require_manifest: bool
) -> bool:
    """CRC gate for one published chain link: the snapshot dir's manifest
    must match the watermark's pin AND the manifest's per-file CRCs must
    hold. Shared by the Follower's poll and the elastic joiner's catch-up
    — both consume the SAME verification before trusting a snapshot."""
    snap = os.path.join(root, rel)
    if want_crc is not None and _manifest_crc(snap) != want_crc:
        return False
    return verify_snapshot(snap, require_manifest=require_manifest)


def apply_published_chain(
    root: str, table: HostSparseTable, require_manifest: bool = True
) -> Optional[Dict[str, Any]]:
    """CRC-verified base + delta chain apply into ``table`` — the
    Follower's chain-apply path, shared with the elastic joiner's
    catch-up so a joining rank trusts a published chain under exactly
    the serve-replica rules.

    Reads ``latest.json`` under ``root`` (atomic publish: a read sees a
    whole watermark or the previous one), validates lineage (including
    the mixed-epoch rejection — the trainer base-re-anchors at every
    ownership-epoch flip, so a valid watermark is always single-epoch:
    catching up across a mid-day re-anchor just means reading the
    re-anchored chain), then verifies and applies base + every delta in
    chain order. Returns the chain-head position dict (``date``,
    ``delta_idx``, ``base_crc``, ``ownership_epoch``) or None on a cold
    root; raises :class:`DeltaLineageError` on any CRC-failed link —
    unlike a serving follower, a catch-up consumer has no last-good
    version to keep, so a bad link is fatal to the attempt."""
    wm = read_watermark(root)
    if wm is None:
        return None
    validate_watermark(wm)
    base_crc = wm["base"].get("manifest_crc")
    idx = int(wm["delta_idx"])
    # compact fast path: a published fold of base+delta-0001..covers loads
    # in one verified link (bitwise-equal to replaying the prefix), so a
    # streaming chain costs a joiner O(post-fold tail), not O(minutes-
    # since-base). A torn fold falls back to the full chain — it is an
    # optimization, never the only copy.
    start = 1
    comp = wm.get("compact")
    if comp is not None:
        if verify_chain_link(
            root, comp["path"], comp.get("manifest_crc"), require_manifest
        ):
            table.load(os.path.join(root, comp["path"]))
            STAT_ADD("serve.compact_fastforwards")
            start = int(comp["covers"]) + 1
        else:
            logger.warning(
                "compact snapshot %s failed CRC — falling back to the "
                "full chain", comp["path"],
            )
    if start == 1:
        if not verify_chain_link(
            root, wm["base"]["path"], base_crc, require_manifest
        ):
            raise DeltaLineageError(
                f"base snapshot {wm['base']['path']!r} under {root} failed "
                "CRC verification"
            )
        table.load(os.path.join(root, wm["base"]["path"]))
    for i in range(start, idx + 1):
        entry = wm["deltas"][i - 1]
        if not verify_chain_link(
            root, entry["path"], entry.get("manifest_crc"), require_manifest
        ):
            raise DeltaLineageError(
                f"delta snapshot {entry['path']!r} under {root} failed "
                "CRC verification (chain order is load-bearing)"
            )
        table.apply_delta(os.path.join(root, entry["path"]))
    return {
        "date": wm["date"],
        "delta_idx": idx,
        "base_crc": base_crc,
        "ownership_epoch": int(wm.get("ownership_epoch", 0)),
    }


class Follower:
    """Tail a checkpoint root and maintain an atomically-served ScoringTable.

    ``trainer`` (optional) is a CTRTrainer used purely as the dense-param
    holder/loader: the follower never trains; it calls ``init_params`` to
    build the params' structure and ``load_dense`` per published dense
    file, which puts them on the trainer's device. ``n_host_shards`` must
    be the publisher's shard count, or the first load raises.
    Threading: ``poll_once``/``run`` mutate follower state from ONE poller
    thread; scorers only touch the immutable versions the ScoringTable
    hands out (each carries the params dict that was current at its
    commit; a dense load builds a new dict instead of writing into it).
    """

    def __init__(
        self,
        root: str,
        layout,
        sparse_opt,
        n_host_shards: int = 4,
        trainer=None,
        require_manifest: Optional[bool] = None,
        device: TierDevices = None,
    ):
        """``device``: where the device scoring tier lives (see
        ``ScoringTable``); read only with ``device_scoring_tier`` on."""
        self.root = root
        self.layout = layout
        self.sparse_opt = sparse_opt
        self.n_host_shards = n_host_shards
        self.trainer = trainer
        self.require_manifest = (
            config.get_flag("serve_require_manifest")
            if require_manifest is None
            else require_manifest
        )
        self.scoring = ScoringTable(layout.width, device=device)
        self._staging = self._fresh_staging()
        # last committed chain position; base_crc pins the lineage so a
        # re-published base under the same date forces a full reload
        self._applied: Optional[Dict[str, Any]] = None
        self._dense_loaded: Optional[str] = None
        # health-gossip surface: ``reanchoring`` is True from the moment a
        # mid-day ownership-epoch flip is detected until the re-anchored
        # chain head is fully applied — the fleet view drains (stops
        # querying) a follower for exactly that window. Written by the one
        # poller thread, read by the health-beat thread.
        self.reanchoring = False
        self.epoch_reanchors = 0  # per-instance (serve.epoch_reanchors is global)

    def _fresh_staging(self) -> HostSparseTable:
        # seed is irrelevant: the staging table only ever load()s published
        # rows, it never creates keys
        return HostSparseTable(
            self.layout, self.sparse_opt, n_shards=self.n_host_shards, seed=0
        )

    # ---- public surface --------------------------------------------------

    def version(self) -> TableVersion:
        return self.scoring.version()

    def health_snapshot(self) -> Dict[str, Any]:
        """The follower half of a ctl:serve:health gossip beat: chain
        position, epoch, re-anchor window, and train-to-serve staleness.
        Reads only atomically-swapped references, so any thread may call
        it concurrently with the poller."""
        v = self.version()
        applied = self._applied
        tier = v.device_tier
        return {
            "delta_idx": v.delta_idx,
            "date": v.date,
            "ownership_epoch": 0 if applied is None else int(
                applied.get("ownership_epoch", 0)),
            "reanchoring": bool(self.reanchoring),
            "epoch_reanchors": int(self.epoch_reanchors),
            "warm": v.params is not None,
            "staleness_s": (
                None if v.published_unix is None
                else max(0.0, time.time() - v.published_unix)
            ),
            # device-tier telemetry: rows the served version holds on its
            # devices and its lookups' hits and misses (0/0/0: host-only)
            "tier_rows": 0 if tier is None else int(tier.n_rows),
            "tier_hits": 0 if tier is None else int(tier.hits),
            "tier_misses": 0 if tier is None else int(tier.misses),
        }

    def poll_once(self) -> bool:
        """One watermark poll; returns True when any new state was applied.

        Raises :class:`DeltaLineageError` on a watermark that conflicts
        with applied history (rewind / malformed chain); propagates
        injected faults from the apply window. ``run`` wraps this with
        alarm-and-keep-serving semantics; tests call it bare.
        """
        STAT_ADD("serve.polls")
        wm = read_watermark(self.root)
        if wm is None:
            return False
        # validate_watermark also rejects mixed-epoch chains (a base and
        # deltas spanning an elastic membership change) with the typed
        # MembershipEpochError — the trainer re-anchors on a fresh base at
        # every ownership-epoch flip, so a mixed chain is always a publish
        # bug, never a state the follower should try to apply
        validate_watermark(wm)
        date, idx = wm["date"], int(wm["delta_idx"])
        base_crc = wm["base"].get("manifest_crc")
        epoch = int(wm.get("ownership_epoch", 0))

        applied = self._applied
        same_lineage = (
            applied is not None
            and applied["date"] == date
            and applied["base_crc"] == base_crc
        )
        if (
            applied is not None
            and applied["date"] == date
            and not same_lineage
            and epoch != applied.get("ownership_epoch", 0)
        ):
            # trainer rank set changed mid-day: the re-anchored base under
            # the new ownership epoch supersedes the old chain wholesale
            STAT_ADD("serve.epoch_reanchors")
            self.epoch_reanchors += 1
            self.reanchoring = True
            logger.info(
                "follower: ownership epoch %s -> %s mid-day (%s) — "
                "reloading from the re-anchored base",
                applied.get("ownership_epoch", 0), epoch, date,
            )
        if same_lineage and idx < applied["delta_idx"]:
            raise DeltaLineageError(
                f"watermark rewound: serving {applied['date']}/delta_idx "
                f"{applied['delta_idx']} but latest.json names delta_idx "
                f"{idx} on the same base — refusing to regress the model"
            )
        advanced = False
        if not same_lineage:
            # new day or re-published base: the old chain's epochs and rows
            # are not comparable — rebuild staging from scratch. A published
            # compact fold fast-forwards the rebuild to delta `covers` in
            # one load (bitwise-equal to replaying the prefix it covers);
            # a torn fold falls back to the classic base walk.
            comp = wm.get("compact")
            anchored = False
            if comp is not None and self._verify(
                comp["path"], comp.get("manifest_crc"), "compact"
            ):
                covers = int(comp["covers"])
                self._staging = self._fresh_staging()
                self._staging.load(os.path.join(self.root, comp["path"]))
                STAT_ADD("serve.compact_fastforwards")
                if covers == idx:
                    self._load_dense(wm)
                self._commit(wm, delta_idx=covers, base_crc=base_crc)
                advanced = anchored = True
            if not anchored:
                if not self._verify(wm["base"]["path"], base_crc, "base"):
                    return False
                self._staging = self._fresh_staging()
                self._staging.load(os.path.join(self.root, wm["base"]["path"]))
                if idx == 0:
                    self._load_dense(wm)
                self._commit(wm, delta_idx=0, base_crc=base_crc)
                advanced = True
        start = self._applied["delta_idx"] + 1
        for i in range(start, idx + 1):
            entry = wm["deltas"][i - 1]
            if not self._verify(entry["path"], entry.get("manifest_crc"), "delta"):
                break  # chain order is load-bearing: stop at the first bad link
            self._staging.apply_delta(os.path.join(self.root, entry["path"]))
            if i == idx:
                # the watermark's dense pairs with the chain HEAD: load it
                # before committing delta idx so any version matching the
                # watermark serves with its exact dense params (mid-chain
                # catch-up versions carry the previous dense)
                self._load_dense(wm)
            self._commit(wm, delta_idx=i, base_crc=base_crc)
            advanced = True
        if self.reanchoring and self._applied["delta_idx"] == idx:
            # re-anchored chain head fully applied: the fleet view may
            # re-admit this follower (a broken link above leaves the flag
            # up — still draining, correctly, until the chain heals)
            self.reanchoring = False
        return advanced

    def run(self, stop: threading.Event, poll_interval_s: Optional[float] = None) -> None:
        """Poll loop with alarm-and-keep-serving semantics: any apply
        failure (corrupt chain, injected crash, lineage conflict) is
        counted and logged, the served version stays the last good one,
        and polling continues — a follower never takes itself out of
        rotation over a bad publish."""
        interval = (
            config.get_flag("serve_poll_interval_s")
            if poll_interval_s is None
            else poll_interval_s
        )
        while not stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — serving must outlive applies
                STAT_ADD("serve.apply_failures")
                logger.error("follower apply failed (still serving last good): %s", e)
            stop.wait(interval)

    # ---- internals -------------------------------------------------------

    def _verify(self, rel: str, want_crc, kind: str) -> bool:
        """Alarm-wrapped :func:`verify_chain_link`: False (+ alarm stats)
        on any mismatch — the caller keeps the last good version
        serving."""
        ok = verify_chain_link(self.root, rel, want_crc, self.require_manifest)
        if not ok:
            STAT_ADD("serve.corrupt_skipped")
            STAT_SET("serve.last_corrupt_unix", time.time())
            logger.error(
                "follower: %s snapshot %s failed CRC verification — "
                "skipping, still serving the last good version", kind, rel,
            )
        return ok

    def _commit(self, wm: Dict[str, Any], delta_idx: int, base_crc) -> None:
        keys = np.sort(self._staging.keys())
        rows = (
            self._staging.pull_or_create(keys)  # all exist: pure read
            if len(keys)
            else np.zeros((0, self.layout.width), dtype=np.float32)
        )
        hotness = None
        if len(keys) and config.get_flag("device_scoring_tier") == "on":
            # decayed-show hotness for the device tier: a pure staging-table
            # peek (the adaptive ICI wire's signal), so opting in cannot
            # perturb the applied state
            hotness = self._staging.shows_peek(keys)
        self.scoring.commit(
            keys,
            rows,
            date=wm["date"],
            delta_idx=delta_idx,
            decay_epoch=self._staging.decay_epochs,
            published_unix=wm.get("published_unix"),
            hotness=hotness,
            # the version carries the dense pair: scorers read params off
            # the version, so sparse+dense swap atomically together
            params=None if self.trainer is None else self.trainer.params,
            opt_state=None if self.trainer is None else self.trainer.opt_state,
        )
        self._applied = {
            "date": wm["date"],
            "delta_idx": delta_idx,
            "base_crc": base_crc,
            "ownership_epoch": int(wm.get("ownership_epoch", 0)),
        }
        STAT_SET("serve.applied_delta_idx", delta_idx)
        STAT_SET("serve.ownership_epoch", int(wm.get("ownership_epoch", 0)))
        STAT_ADD("serve.applies")
        # end-to-end freshness (the streaming-plane SLO): when the trainer
        # is a StreamSupervisor the watermark carries the ingest timestamp
        # of the OLDEST record in the publish; committing the chain head
        # means that record is now servable, so sample event→served
        # latency here. Mid-chain catch-up commits are skipped — they
        # serve older state and would double-count the head's interval.
        stream = wm.get("stream")
        if stream is not None and delta_idx == int(wm["delta_idx"]):
            oldest = stream.get("oldest_unix")
            if oldest is not None:
                STAT_OBSERVE(
                    "serve.freshness_s", max(0.0, time.time() - float(oldest))
                )

    def _load_dense(self, wm: Dict[str, Any]) -> None:
        dense = wm.get("dense")
        if self.trainer is None or dense is None:
            return
        rel = dense["path"]
        if rel == self._dense_loaded:
            return
        path = os.path.join(self.root, rel)
        if not os.path.exists(path):
            STAT_ADD("serve.dense_skipped")
            logger.error("follower: dense file %s missing — keeping previous params", rel)
            return
        want = dense.get("crc32")
        if want is not None and _file_crc32(path) != want:
            STAT_ADD("serve.dense_skipped")
            logger.error("follower: dense file %s failed CRC — keeping previous params", rel)
            return
        if self.trainer.params is None:
            self.trainer.init_params()
        self.trainer.load_dense(path)
        self._dense_loaded = rel
        STAT_ADD("serve.dense_loads")
