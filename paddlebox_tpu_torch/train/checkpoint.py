"""CheckpointManager: base + delta model publishing and day-level resume.

Port of the JAX package's ``train/checkpoint.py``; the directory layout,
the manifests, the cursors and the ``latest.json`` watermark are the same,
so a chain written by either package resumes (and is followed) in the
other. The reference checkpoints in the model domain (SURVEY.md §5): BoxPS
``SaveBase(path, date)`` writes the full sparse model, ``SaveDelta`` the
keys touched since the last save (box_wrapper.cc:1288-1331), the dense
params dump from the worker scope (boxps_trainer.cc:123-131), and resume
is ``InitializeGPUAndLoadModel(model_path)`` plus day staging.

Directory layout:

    root/
      cursor.json                  {"date", "delta_idx", ...}: last durable state
      cursor.prev.json             the cursor this one replaced (fallback)
      latest.json                  the follower-facing watermark
      <date>/base/                 full sparse snapshot (HostSparseTable dir)
      <date>/delta-NNNN/           touched-key snapshots, applied in order
      <date>/compact-NNNN/         optional fold of base + delta-0001..NNNN
      <date>/dense-NNNN.npz        dense params + optimizer state per save

Durability:

- A sparse snapshot is written to a ``.tmp`` sibling, stamped with a
  ``manifest.json`` of per-file size and CRC32, and published with
  ``os.replace``: a crash mid-save never leaves a half-written dir under
  the final name.
- The cursor is rewritten (atomically) only after every artifact it names
  is durable, then the watermark after the cursor.
- ``resume()`` verifies the manifests before trusting a snapshot and walks
  back to the newest consistent state (a shorter delta chain, or the
  previous cursor) instead of loading a torn one.

Fault sites (``utils/faultinject``), fired in the JAX package's order so
one fault plan hits the same window in both packages:
``checkpoint.save`` at each durability boundary of save_base/save_delta (4
a save), ``checkpoint.load`` in resume() before the base load and before
each delta, ``ckpt.compact`` at the three windows of compact().
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
import zlib
from typing import Any, Dict, Optional

from paddlebox_tpu_torch.table.sparse_table import HostSparseTable
from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire
from paddlebox_tpu_torch.utils.fs import atomic_write
from paddlebox_tpu_torch.utils.monitor import STAT_ADD

logger = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
LATEST_NAME = "latest.json"


class DeltaLineageError(RuntimeError):
    """A delta publish or apply that does not extend the recorded lineage.

    Deltas are meaningful only as an ordered chain over one base: a gap in
    the chain, a rewound index, or a watermark whose listed dirs disagree
    with its own (date, delta_idx) all mean some writer skipped the
    protocol. Producers refuse to publish over a broken chain; followers
    refuse to apply one — silently proceeding would serve a model state
    no trainer ever held.
    """


class MembershipEpochError(DeltaLineageError):
    """A delta chain spanning more than one ownership epoch.

    Each delta snapshots the keys ONE rank owned when it was published; if
    ownership re-sharded mid-chain (rank death, planned migration), deltas
    before and after the flip cover different key ranges and their
    composition is not any state one trainer held. Producers refuse to
    extend a chain across an epoch flip (they re-anchor with a fresh base
    instead), and ``validate_watermark`` rejects a mixed-epoch chain with
    this typed error so a follower alarms instead of serving a chimera.
    """


def rank_root(root: str, rank: int) -> str:
    """Per-rank checkpoint root under a shared day root.

    Every rank publishes its owned shard slice under ``rank-<r>``, so a
    survivor can open a dead rank's chain read-only and adopt its ranges
    through the same manifest-verified resume path."""
    return os.path.join(root, f"rank-{int(rank)}")


def _file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


def write_manifest(snap_dir: str) -> str:
    """Stamp ``snap_dir`` with per-file size+CRC32 over its current
    contents. Written atomically (tmp + replace) so a torn manifest can
    never pass for a complete one."""
    files: Dict[str, Dict[str, int]] = {}
    for name in sorted(os.listdir(snap_dir)):
        p = os.path.join(snap_dir, name)
        if name == MANIFEST_NAME or not os.path.isfile(p):
            continue
        files[name] = {"size": os.path.getsize(p), "crc32": _file_crc32(p)}
    mpath = os.path.join(snap_dir, MANIFEST_NAME)
    with atomic_write(mpath) as f:
        json.dump({"files": files}, f)
    return mpath


def verify_snapshot(snap_dir: str, require_manifest: bool = False) -> bool:
    """True iff ``snap_dir`` holds a complete, uncorrupted snapshot.

    Every manifest entry must exist with the recorded size and CRC32. A
    dir without a manifest is a pre-manifest (legacy) snapshot: accepted
    unless ``require_manifest`` (counted so operators can see unverified
    loads), since refusing would brick every old checkpoint tree."""
    if not os.path.isdir(snap_dir):
        return False
    mpath = os.path.join(snap_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        if require_manifest:
            return False
        STAT_ADD("ckpt_unverified_snapshots")
        return os.path.exists(os.path.join(snap_dir, "meta.json"))
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for name, want in manifest["files"].items():
            p = os.path.join(snap_dir, name)
            if not os.path.exists(p):
                return False
            if os.path.getsize(p) != want["size"]:
                return False
            if _file_crc32(p) != want["crc32"]:
                return False
    except (OSError, ValueError, KeyError):
        # a torn/unreadable manifest is a FAILED verification, not a mere
        # "no": resume walks on to an older snapshot, which operators
        # should see happening
        STAT_ADD("ckpt_verify_failures")
        return False
    return True


def _manifest_crc(snap_dir: str) -> Optional[int]:
    """CRC32 of a snapshot's manifest file (None when unstamped). Pins the
    watermark to one exact publish of each snapshot: a re-published dir
    under the same name gets a new manifest CRC, so a follower can tell
    'same chain link' from 'same path, different contents'."""
    mpath = os.path.join(snap_dir, MANIFEST_NAME)
    try:
        return _file_crc32(mpath)
    # absence probe: None is the answer (no manifest, legacy snapshot)
    # pbox-lint: disable=EXC007
    except OSError:
        return None


def read_watermark(root: str) -> Optional[Dict[str, Any]]:
    """The published ``latest.json`` under ``root``, or None when absent
    or torn (a torn watermark reads as 'nothing published yet', never as
    garbage — the same discipline as cursor reads)."""
    path = os.path.join(root, LATEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    # absent-or-torn watermark reads as None by design: the atomic
    # publish means a reader never has to distinguish the two
    # pbox-lint: disable=EXC007
    except (OSError, ValueError):
        return None


def validate_watermark(wm: Dict[str, Any]) -> None:
    """Structural + lineage check of a watermark; raises
    :class:`DeltaLineageError` when the listed chain is not exactly
    base + delta-0001..delta-NNNN for the watermark's own (date, delta_idx).
    """
    try:
        date = wm["date"]
        idx = int(wm["delta_idx"])
        base = wm["base"]["path"]
        deltas = [d["path"] for d in wm["deltas"]]
    except (KeyError, TypeError, ValueError) as e:
        raise DeltaLineageError(f"malformed watermark {wm!r}: {e}") from e
    if idx < 0:
        raise DeltaLineageError(f"watermark delta_idx {idx} is negative")
    # one chain, one ownership epoch: entries published under different
    # epochs cover different key ranges and must never compose
    chain_entries = [wm["base"]] + list(wm["deltas"])
    if isinstance(wm.get("compact"), dict):
        chain_entries.append(wm["compact"])
    epochs = {
        e.get("ownership_epoch")
        for e in chain_entries
        if isinstance(e, dict) and "ownership_epoch" in e
    }
    if len(epochs) > 1:
        raise MembershipEpochError(
            f"watermark chain for {date!r} mixes ownership epochs "
            f"{sorted(epochs)} — an epoch flip must re-anchor with a new "
            "base, not extend the old chain"
        )
    if base != f"{date}/base":
        raise DeltaLineageError(
            f"watermark base {base!r} does not belong to date {date!r}"
        )
    want = [f"{date}/delta-{i:04d}" for i in range(1, idx + 1)]
    if deltas != want:
        raise DeltaLineageError(
            f"watermark delta chain {deltas} is out of lineage — "
            f"delta_idx {idx} requires exactly {want} (ordered, gap-free)"
        )
    comp = wm.get("compact")
    if comp is not None:
        # optional fast-forward artifact: a fold of base+delta-0001..covers.
        # It substitutes for a chain PREFIX, so it must name a link the
        # chain actually has — otherwise a follower could fast-forward past
        # state this watermark never published.
        try:
            covers = int(comp["covers"])
            cpath = comp["path"]
        except (KeyError, TypeError, ValueError) as e:
            raise DeltaLineageError(f"malformed compact entry {comp!r}: {e}") from e
        if not 1 <= covers <= idx or cpath != f"{date}/compact-{covers:04d}":
            raise DeltaLineageError(
                f"compact entry {comp!r} is out of lineage for {date!r} at "
                f"delta_idx {idx}"
            )


class CheckpointManager:
    def __init__(self, root: str):
        self.root = root
        # the key-ownership epoch this manager publishes under; one host
        # stays at 0. A multi-host supervisor (not ported yet) bumps it when
        # membership changes: the next save_base re-anchors the chain, and
        # save_delta refuses to straddle the flip.
        self.ownership_epoch = 0
        # the live rank set of that epoch (None = not elastic), surfaced in
        # the watermark so a follower sees the fleet size a chain was
        # published under
        self.live_ranks: Optional[list] = None
        # streaming provenance ({"cut_seq", "oldest_unix", "records"}) a
        # streaming publisher stamps before each save; the watermark
        # carries it and the follower turns "oldest_unix" into the
        # serve.freshness_s histogram
        self.stream_meta: Optional[Dict[str, Any]] = None
        os.makedirs(root, exist_ok=True)

    # ---- paths -----------------------------------------------------------

    def _day(self, date: str) -> str:
        return os.path.join(self.root, date)

    def _cursor_path(self) -> str:
        return os.path.join(self.root, "cursor.json")

    def _prev_cursor_path(self) -> str:
        return os.path.join(self.root, "cursor.prev.json")

    def _read_cursor(self, path: str) -> Optional[Dict[str, Any]]:
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        # pbox-lint: disable=EXC007 — same contract as read_watermark
        except (OSError, ValueError):
            return None  # a torn cursor reads as absent, never as garbage

    def cursor(self) -> Optional[Dict[str, Any]]:
        return self._read_cursor(self._cursor_path())

    def prev_cursor(self) -> Optional[Dict[str, Any]]:
        return self._read_cursor(self._prev_cursor_path())

    def _write_cursor(
        self,
        date: str,
        delta_idx: int,
        dense: Optional[str],
        compact: Optional[int] = None,
    ) -> None:
        cur = {
            "date": date,
            "delta_idx": delta_idx,
            "ownership_epoch": self.ownership_epoch,
        }
        if dense is not None:
            cur["dense"] = dense  # the dense file this sparse state pairs with
        if compact:
            # newest fold of base+delta-0001..compact; carried forward by
            # save_delta, reset by save_base (a new chain has no fold yet)
            cur["compact"] = int(compact)
        # keep the superseded cursor as the fallback anchor: if every
        # artifact of the NEW state later verifies torn (bit rot, torn
        # copy), resume() can still land on the previous consistent state
        old = self.cursor()
        if old is not None and old != cur:
            with atomic_write(self._prev_cursor_path()) as f:
                json.dump(old, f)
        with atomic_write(self._cursor_path()) as f:  # crash-safe cursor
            json.dump(cur, f)
        # the cursor is the trainer's resume anchor; the watermark is the
        # FOLLOWER-facing view of the same commit. Published strictly after
        # the cursor, so a watermark never names a state the producer
        # itself would not resume into.
        self._publish_watermark(cur)

    # ---- follower watermark ---------------------------------------------

    def _latest_path(self) -> str:
        return os.path.join(self.root, LATEST_NAME)

    def _publish_watermark(self, cur: Dict[str, Any]) -> None:
        """Atomically publish ``latest.json``: the base + ordered delta
        chain (each entry pinned by its manifest CRC32) plus the paired
        dense file. atomic_write means a tailing follower either sees the
        previous complete watermark or this one — never a half-published
        save."""
        date, idx = cur["date"], cur["delta_idx"]
        epoch = int(cur.get("ownership_epoch", 0))

        def entry(rel: str) -> Dict[str, Any]:
            return {
                "path": rel,
                "manifest_crc": _manifest_crc(os.path.join(self.root, rel)),
                # save_delta refuses to straddle an epoch flip, so every
                # entry of one chain carries the base's epoch — a follower
                # validates exactly that (validate_watermark)
                "ownership_epoch": epoch,
            }

        wm: Dict[str, Any] = {
            "date": date,
            "delta_idx": idx,
            "ownership_epoch": epoch,
            "base": entry(f"{date}/base"),
            "deltas": [entry(f"{date}/delta-{i:04d}") for i in range(1, idx + 1)],
            "published_unix": time.time(),
        }
        if self.live_ranks is not None:
            wm["live_ranks"] = [int(r) for r in self.live_ranks]
        dense = cur.get("dense")
        if dense is not None:
            dpath = os.path.join(self._day(date), dense)
            wm["dense"] = {
                "path": f"{date}/{dense}",
                "crc32": _file_crc32(dpath) if os.path.exists(dpath) else None,
            }
        comp = int(cur.get("compact") or 0)
        if comp >= 1:
            rel = f"{date}/compact-{comp:04d}"
            wm["compact"] = {
                "path": rel,
                "covers": comp,
                "manifest_crc": _manifest_crc(os.path.join(self.root, rel)),
                "ownership_epoch": epoch,
            }
        if self.stream_meta is not None:
            wm["stream"] = dict(self.stream_meta)
        with atomic_write(self._latest_path()) as f:
            json.dump(wm, f)
        STAT_ADD("ckpt_watermark_publishes")

    def read_watermark(self) -> Optional[Dict[str, Any]]:
        return read_watermark(self.root)

    # ---- save ------------------------------------------------------------

    def _publish_snapshot(self, write_fn, final_dir: str) -> None:
        """tmp dir -> write_fn -> manifest -> atomic rename to final_dir.

        A crash anywhere before the rename leaves only the ``.tmp``
        sibling; the final name either doesn't exist or holds the complete
        previous snapshot. Retried saves clear stale tmp leftovers."""
        tmp = final_dir + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)  # torn leftover from a failed attempt
        os.makedirs(tmp, exist_ok=True)
        write_fn(tmp)
        _fault_fire("checkpoint.save")  # window: sparse written, unpublished
        write_manifest(tmp)
        if os.path.isdir(final_dir):
            # a complete snapshot is being overwritten (re-save of the same
            # pass after a downstream failure): drop it just before the
            # rename — the cursor never points here until we finish
            shutil.rmtree(final_dir)
        os.replace(tmp, final_dir)

    def save_base(self, date: str, table: HostSparseTable, trainer=None) -> str:
        """Full sparse snapshot + dense (SaveBase parity). Resets the day's
        delta counter — deltas are relative to this base."""
        _fault_fire("checkpoint.save")  # window: nothing written yet
        day = self._day(date)
        base_dir = os.path.join(day, "base")
        self._publish_snapshot(table.save_base, base_dir)
        _fault_fire("checkpoint.save")  # window: sparse published, no dense
        dense = None
        if trainer is not None:
            dense = "dense-0000.npz"
            trainer.save_dense(os.path.join(day, dense))
        _fault_fire("checkpoint.save")  # window: all durable, cursor stale
        self._write_cursor(date, delta_idx=0, dense=dense)
        return base_dir

    def save_delta(self, date: str, table: HostSparseTable, trainer=None) -> str:
        """Touched-keys snapshot (SaveDelta / xbox online-publish parity).

        Requires a base for ``date`` (deltas apply on top of it in order).
        Each save writes its OWN dense file, named in the cursor only after
        both sparse and dense are durable — a crash between the two can
        never publish a sparse/dense skew (the cursor still points at the
        previous consistent pair).
        """
        cur = self.cursor()
        if cur is None or cur["date"] != date:
            raise RuntimeError(
                f"no base saved for date {date!r} — save_base first "
                "(deltas are relative to a base)"
            )
        if int(cur.get("ownership_epoch", 0)) != int(self.ownership_epoch):
            raise MembershipEpochError(
                f"chain for {date!r} was published under ownership epoch "
                f"{cur.get('ownership_epoch', 0)} but this rank is now at "
                f"epoch {self.ownership_epoch} — save_base to re-anchor "
                "(a delta must not straddle a membership flip)"
            )
        _fault_fire("checkpoint.save")  # window: nothing written yet
        idx = cur["delta_idx"] + 1
        day = self._day(date)
        missing = [
            i for i in range(1, idx)
            if not os.path.isdir(os.path.join(day, f"delta-{i:04d}"))
        ]
        if missing:
            # the cursor promises a contiguous chain; a hole means someone
            # deleted mid-chain links — publishing delta N on top would
            # hand followers a chain no trainer state corresponds to
            raise DeltaLineageError(
                f"cursor for {date} is at delta_idx {idx - 1} but delta "
                f"dir(s) {missing} are missing — refusing an out-of-lineage "
                "publish (restore the chain or save_base to start a new one)"
            )
        path = os.path.join(day, f"delta-{idx:04d}")
        # defer the touched-set clear until the cursor commits: a save that
        # crashes after publishing (but before the cursor names it) retries
        # with the SAME touched keys instead of snapshotting an empty delta
        # over the published one
        self._publish_snapshot(
            lambda d: table.save_delta(d, clear_touched=False), path
        )
        _fault_fire("checkpoint.save")  # window: delta published, no dense
        dense = cur.get("dense")
        if trainer is not None:
            dense = f"dense-{idx:04d}.npz"
            trainer.save_dense(os.path.join(day, dense))
        _fault_fire("checkpoint.save")  # window: all durable, cursor stale
        self._write_cursor(
            date, delta_idx=idx, dense=dense, compact=cur.get("compact")
        )
        table.clear_touched()  # delta committed: keys count as saved now
        # retire dense files older than the previous cursor (keep one back
        # for safety against torn reads of cursor.json readers) — but never
        # the file the new cursor itself references (deltas saved with
        # trainer=None carry the older dense name forward)
        for i in range(idx - 1):
            name = f"dense-{i:04d}.npz"
            if name == dense:
                continue
            stale = os.path.join(day, name)
            if os.path.exists(stale):
                try:
                    os.remove(stale)
                except OSError as e:
                    # a leaked dense file is an ops problem (disk creep on
                    # multi-day runs) — count it and say which file
                    STAT_ADD("ckpt_dense_retire_failures")
                    logger.warning(
                        "failed to retire stale dense checkpoint %s: %s",
                        stale, e,
                    )
        return path

    # ---- compaction ------------------------------------------------------

    def compact(self, date: str, scratch: HostSparseTable) -> Optional[str]:
        """Fold base + delta-0001..N into one full snapshot ``compact-NNNN``.

        The streaming plane publishes a delta per micro-pass, so a chain
        grows O(minutes-since-base) links; the fold caps follower catch-up
        and trainer resume at one full load + the post-fold tail. The fold
        is an exact sequential replay of the chain into ``scratch`` (a
        fresh, EMPTY table with the live table's layout/opt/shards): each
        delta apply performs its own decay catch-up step exactly as a
        follower would, so the materialized state — published via
        ``save_base`` as a full kind="base" snapshot — is bitwise-equal to
        applying the chain, by construction. (A touched-keys re-snapshot
        would NOT be: per-micro-pass decay is stepwise fp32 ``v*r*r*...``,
        not one ``v*r**n``.)

        Crash discipline mirrors save_delta (fault site ``ckpt.compact``):
        the fold publishes atomically under ``compact-NNNN`` and only then
        does the cursor (and watermark) name it — any crash leaves the old
        chain servable bitwise, and a healed retry refolds to the identical
        artifact. Like ``save_delta`` it refuses to straddle an ownership-
        epoch flip: a fold of a pre-flip chain is state no current trainer
        holds. Old delta dirs are NOT deleted (the uncompacted chain stays
        valid; lineage validation is unchanged).

        Returns the published dir, or None when there is nothing new to
        fold (idempotent).
        """
        cur = self.cursor()
        if cur is None or cur["date"] != date:
            raise RuntimeError(
                f"no chain for date {date!r} to compact — save_base first"
            )
        if int(cur.get("ownership_epoch", 0)) != int(self.ownership_epoch):
            raise MembershipEpochError(
                f"chain for {date!r} was published under ownership epoch "
                f"{cur.get('ownership_epoch', 0)} but this rank is now at "
                f"epoch {self.ownership_epoch} — a compact must not "
                "straddle a membership flip (save_base re-anchors first)"
            )
        n = int(cur["delta_idx"])
        if n < 1 or int(cur.get("compact") or 0) >= n:
            return None
        _fault_fire("ckpt.compact")  # window: nothing read yet
        day = self._day(date)
        links = [os.path.join(day, "base")] + [
            os.path.join(day, f"delta-{i:04d}") for i in range(1, n + 1)
        ]
        for link in links:
            # CRC-pinned replay: folding a torn link would LAUNDER the
            # corruption into a snapshot that then verifies clean
            if not verify_snapshot(link):
                raise DeltaLineageError(
                    f"refusing to compact over torn chain link {link!r}"
                )
        scratch.load(links[0])
        for link in links[1:]:
            scratch.apply_delta(link)
        _fault_fire("ckpt.compact")  # window: folded in memory, unpublished
        comp_dir = os.path.join(day, f"compact-{n:04d}")
        self._publish_snapshot(scratch.save_base, comp_dir)
        _fault_fire("ckpt.compact")  # window: published, cursor stale
        # re-read: the chain may have grown while we folded — the fold
        # still covers exactly n, the tail stays as deltas
        cur = self.cursor() or cur
        self._write_cursor(
            cur["date"], cur["delta_idx"], cur.get("dense"), compact=n
        )
        STAT_ADD("ckpt_compactions")
        return comp_dir

    # ---- resume ----------------------------------------------------------

    def _consistent_state(self, cur: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Verify ``cur``'s artifacts; return the newest consistent state
        reachable from it (possibly a shorter delta chain), or None when
        even the base is torn/missing."""
        day = self._day(cur["date"])
        # a verified compact fold substitutes for the chain PREFIX it
        # covers, so it rescues states the classic walk cannot reach: a
        # torn base, or a torn mid-chain delta <= covers. When both paths
        # are whole they load bitwise-identical state (compact invariant);
        # the fold is preferred because it applies fewer links.
        covers = int(cur.get("compact") or 0)
        comp_ok = covers >= 1 and verify_snapshot(
            os.path.join(day, f"compact-{covers:04d}")
        )
        if comp_ok:
            m = covers
        elif verify_snapshot(os.path.join(day, "base")):
            m = 0
        else:
            return None
        for i in range(m + 1, cur["delta_idx"] + 1):
            if not verify_snapshot(os.path.join(day, f"delta-{i:04d}")):
                break  # deltas apply in order: a torn link truncates the chain
            m = i
        dense = cur.get("dense")
        if m < cur["delta_idx"]:
            # walked back: the cursor's dense pairs with the full chain, so
            # re-pair with the newest surviving dense at or below m
            dense = None
            for i in range(m, -1, -1):
                name = f"dense-{i:04d}.npz"
                if os.path.exists(os.path.join(day, name)):
                    dense = name
                    break
        state = {
            "date": cur["date"],
            "delta_idx": m,
            "dense": dense,
            # the epoch this chain was published under: shard adoption
            # compares it against the live map to detect a chain that
            # predates the last ownership flip (membership.py)
            "ownership_epoch": int(cur.get("ownership_epoch", 0)),
        }
        if comp_ok:
            # load compact-NNNN in place of base + delta-0001..NNNN;
            # absent when no verified fold is in play
            state["compact"] = covers
        return state

    def resume(self, table: HostSparseTable, trainer=None) -> Optional[Dict[str, Any]]:
        """Rebuild the newest durable state into ``table`` (+ trainer dense).

        Every snapshot is manifest-verified before it is trusted: a torn
        delta truncates the chain to the last consistent link, a torn base
        falls back to the previous cursor's state — resume never loads a
        half-written snapshot. Returns the state actually loaded
        ({"date", "delta_idx", ...}) or None when nothing consistent was
        ever saved (cold start).
        """
        cur = self.cursor()
        if cur is None:
            # a torn/missing cursor with an intact predecessor is a crash
            # mid-rotation, not a cold start — resume from the predecessor
            cur = self.prev_cursor()
            if cur is None:
                return None
            STAT_ADD("ckpt_resume_fallbacks")
            logger.warning("cursor unreadable; resuming from prev cursor %s", cur)
        state = self._consistent_state(cur)
        if state is None or state["delta_idx"] < cur["delta_idx"]:
            STAT_ADD("ckpt_resume_fallbacks")
            logger.warning(
                "checkpoint state %s is torn; falling back (candidate: %s)",
                cur, state,
            )
        if state is None:
            prev = self.prev_cursor()
            if prev is not None:
                state = self._consistent_state(prev)
            if state is None:
                raise RuntimeError(
                    f"no consistent checkpoint reachable from cursor {cur} "
                    f"(prev {self.prev_cursor()}) — every candidate snapshot "
                    "failed manifest verification"
                )
        day = self._day(state["date"])
        comp = int(state.get("compact") or 0)
        _fault_fire("checkpoint.load")
        if comp >= 1:
            # the fold is a full kind="base" snapshot of base+delta-0001..
            # comp — bitwise-equal to replaying that prefix, loaded in one
            table.load(os.path.join(day, f"compact-{comp:04d}"))
            STAT_ADD("ckpt_compact_resumes")
        else:
            table.load(os.path.join(day, "base"))
        for i in range(comp + 1, state["delta_idx"] + 1):
            _fault_fire("checkpoint.load")
            table.apply_delta(os.path.join(day, f"delta-{i:04d}"))
        # per-save dense file named in the cursor; "dense.npz" is the
        # pre-versioning layout (older checkpoints)
        dense = os.path.join(day, state.get("dense") or "dense.npz")
        if trainer is not None and os.path.exists(dense):
            if trainer.params is None:
                trainer.init_params()
            trainer.load_dense(dense)
        return state
