"""StreamSupervisor: crash-safe tail-follow ingestion and micro-pass publish.

Port of the JAX package's ``train/stream.py`` for one process. The pass
machinery becomes a streaming plane:

- :class:`DirectoryTailer` tail-follows an append-only dataset directory:
  per-file byte offset + incremental CRC32 over the bytes it has consumed,
  only COMPLETE lines are ever handed out (an incomplete last line of a
  still-appending file is held back for the next poll, never quarantined
  as a bad record), and the consumed-prefix CRC proves on restart that
  nobody rewrote history under the cursor.

- :class:`StreamSupervisor` cuts micro-passes on a TIME budget
  (``stream_micro_pass_s``) instead of a file list and drives each cut
  through the :class:`~paddlebox_tpu_torch.train.supervisor.
  PassSupervisor` machinery: retry and rollback and quarantine admission
  apply unchanged. Each cut publishes a delta through the normal
  watermark/lineage path; the watermark additionally carries
  ``{"stream": {"cut_seq", "oldest_unix", "records"}}`` so followers can
  sample the end-to-end ``serve.freshness_s`` histogram at commit.

Durability (the robustness tentpole) is a two-phase durable cursor under
the checkpoint root, written via ``atomic_write``:

    stream_cursor.json      {"cut_seq", "files": {rel: {offset, crc32}},
                             "pending": null | {...}, "published": {...}}
    stream_spool/cut-NNNNNN.txt   the exact records of one cut, durable
                                  BEFORE training starts

A cut is: (1) spool the polled records, (2) write the cursor with a
``pending`` intent naming the spool (size+CRC pinned) and the post-read
file positions, (3) train+publish the spool through ``run_pass``, (4)
commit the cursor (pending adopted). Recovery after a crash is
exactly-once by construction: a pending whose cut_seq the published
watermark already carries is finalized WITHOUT retraining (no
double-count); a pending that never published replays the SAME durable
spool (no loss, bitwise-identical to the uninterrupted run); a torn
intent is discarded and the committed positions re-read the same bytes.

Compaction: every ``stream_compact_every`` micro-deltas the supervisor
calls :meth:`CheckpointManager.compact`, folding base+delta-0001..N into
one full ``compact-NNNN`` snapshot (bitwise-equal by sequential replay)
so follower catch-up stays O(hours) not O(minutes-since-base).

Backlog degrades gracefully: when a cut overruns its budget the window
stretches (doubling, capped at ``stream_backlog_max_stretch``×budget,
counted under ``stream.backlog_stretches``) and shrinks back once cuts
run under half budget — cadence bends, the stream never crashes.

Fault sites (utils/faultinject): ``stream.tail_read`` fires before each
file's new byte range is consumed; ``stream.cut_publish`` fires at the
two cut crash windows (intent durable / published but cursor stale);
``ckpt.compact`` lives in checkpoint.py.

Coordinated streaming ranks (a supervisor with a coordinator) fence each
cut with two verdict rounds on the host transport: ``stream_cut_round``
before training (every rank agrees that cut N happens) and
``stream_confirm_round`` after the publish (every rank's delta N is
durable). A peer's no aborts the cut before anything trains.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.table.sparse_table import HostSparseTable
from paddlebox_tpu_torch.train.checkpoint import MembershipEpochError, _file_crc32
from paddlebox_tpu_torch.utils.faultinject import fire as _fault_fire
from paddlebox_tpu_torch.utils.fs import atomic_write
from paddlebox_tpu_torch.utils.monitor import STAT_ADD, STAT_OBSERVE

logger = logging.getLogger(__name__)

STREAM_CURSOR_NAME = "stream_cursor.json"
SPOOL_DIR_NAME = "stream_spool"


class StreamLineageError(RuntimeError):
    """The append-only contract of the streamed directory was violated.

    The ingest cursor records a CRC32 over every byte it has consumed; on
    resume the tailer re-hashes those prefixes. A mismatch means a file
    was rewritten or truncated under the cursor — the records already
    trained on no longer exist as recorded, so "resume from the cursor"
    has no meaning. Refusing loudly beats silently re-training rewritten
    history as if it were the original.
    """


def _incremental_crc(path: str, length: int, chunk: int = 1 << 20) -> int:
    """CRC32 over the first ``length`` bytes of ``path``."""
    crc = 0
    remaining = length
    with open(path, "rb") as f:
        while remaining > 0:
            buf = f.read(min(chunk, remaining))
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
            remaining -= len(buf)
    return crc


class DirectoryTailer:
    """Tail-follow an append-only directory of line-oriented record files.

    ``poll()`` scans for files matching ``pattern`` (sorted by name, so
    consumption order is deterministic), reads each file's bytes past its
    recorded offset, and returns the COMPLETE lines found. The bytes after
    the last newline of a still-growing file are the partial-tail hazard:
    they are a record some writer has not finished flushing, so the offset
    never advances past them and they are re-read (whole) on a later poll
    — never handed to the pass loader as a torn record.

    ``positions`` maps relative filename → {"offset", "crc32"} where the
    CRC is incremental over exactly the consumed bytes; it is the
    in-memory half of the durable stream cursor. ``resume(positions)``
    installs a cursor and re-hashes every consumed prefix, raising
    :class:`StreamLineageError` on an append-only violation.

    Records are stamped with the wall-clock of the PREVIOUS poll: a record
    discovered now was absent then, so it was appended no earlier — the
    stamp is a floor on its append time and the freshness SLO computed
    from it overestimates by at most one poll interval (conservative).
    """

    def __init__(self, dirpath: str, pattern: str = "*", wall=time.time):
        self.dirpath = dirpath
        self.pattern = pattern
        self.wall = wall
        self.positions: Dict[str, Dict[str, int]] = {}
        self._prev_poll_unix = float(wall())

    def resume(self, positions: Dict[str, Dict[str, int]]) -> None:
        """Install a durable cursor and verify the consumed prefixes."""
        for rel, pos in positions.items():
            path = os.path.join(self.dirpath, rel)
            off = int(pos["offset"])
            if off == 0:
                continue
            if not os.path.exists(path):
                raise StreamLineageError(
                    f"stream cursor names {rel!r} at offset {off} but the "
                    "file is gone — the streamed directory is append-only"
                )
            if os.path.getsize(path) < off:
                raise StreamLineageError(
                    f"{rel!r} shrank below the consumed offset {off} — "
                    "the streamed directory is append-only"
                )
            if _incremental_crc(path, off) != int(pos["crc32"]):
                raise StreamLineageError(
                    f"consumed prefix of {rel!r} (first {off} bytes) no "
                    "longer matches the cursor CRC — history was rewritten "
                    "under the stream cursor"
                )
        self.positions = {
            rel: {"offset": int(p["offset"]), "crc32": int(p["crc32"])}
            for rel, p in positions.items()
        }

    def _list_files(self) -> List[str]:
        try:
            names = os.listdir(self.dirpath)
        # a not-yet-created stream dir is an empty stream, not an error
        # pbox-lint: disable=EXC007
        except OSError:
            return []
        return sorted(n for n in fnmatch.filter(names, self.pattern)
                      if not n.endswith(".tmp"))

    def poll(self) -> Tuple[List[str], float]:
        """One scan; returns (new complete lines, conservative stamp).

        A file whose read fails (I/O error or injected ``stream.tail_read``
        fault) is skipped WITHOUT advancing its position — the next poll
        re-reads the same byte range, so a transient read failure costs
        latency, never records (counted under ``stream.tail_read_errors``).
        """
        stamp = self._prev_poll_unix
        self._prev_poll_unix = float(self.wall())
        lines: List[str] = []
        for rel in self._list_files():
            path = os.path.join(self.dirpath, rel)
            pos = self.positions.setdefault(rel, {"offset": 0, "crc32": 0})
            try:
                _fault_fire("stream.tail_read")
                with open(path, "rb") as f:
                    f.seek(pos["offset"])
                    buf = f.read()
            except OSError as e:  # includes InjectedFault
                STAT_ADD("stream.tail_read_errors")
                logger.warning(
                    "stream: tail read of %s failed (position held, will "
                    "re-read): %s", rel, e,
                )
                continue
            if not buf:
                continue
            # partial-tail holdback: only bytes up to (and including) the
            # last newline are consumed; a writer mid-flush keeps its torn
            # record private until it finishes the line
            cut = buf.rfind(b"\n")
            if cut < 0:
                continue
            consumed = buf[: cut + 1]
            # undecodable bytes inside a COMPLETE line are a bad record,
            # not a torn one: keep the line (with replacement chars) so the
            # pass loader's quarantine path judges it, same as file input
            lines.extend(consumed.decode("utf-8", errors="replace").splitlines())
            pos["offset"] += len(consumed)
            pos["crc32"] = zlib.crc32(consumed, pos["crc32"])
            STAT_ADD("stream.bytes_consumed", len(consumed))
        if lines:
            STAT_ADD("stream.records_polled", len(lines))
        return lines, stamp

    def snapshot_positions(self) -> Dict[str, Dict[str, int]]:
        return {rel: dict(p) for rel, p in self.positions.items()}


# ---- micro-pass boundary protocol ----------------------------------------
#
# Coordinated streaming ranks fence each cut with the verdict vocabulary of
# every other boundary (ctl:verdict:<key>@e<N>, through
# EpochCoordinator.exchange_verdict): a cut round before training and a
# confirm round after publish. A single-rank stream (coord is None) skips
# both; its exactly-once story is the durable cursor.


def stream_cut_round(coord, cut_seq: int, ok: bool = True, detail: str = ""):
    """The epoch-fenced agreement that micro-pass ``cut_seq`` is cut."""
    return coord.exchange_verdict(f"stream-cut:{cut_seq}", ok, detail)


def stream_confirm_round(coord, cut_seq: int, ok: bool = True, detail: str = ""):
    """The epoch-fenced confirmation that ``cut_seq``'s publish is durable."""
    return coord.exchange_verdict(f"stream-confirm:{cut_seq}", ok, detail)


class StreamSupervisor:
    """Drive a PassSupervisor from a tailed append-only directory.

    One instance owns the stream cursor under ``supervisor.checkpoint``'s
    root. Constructing it runs crash recovery (see module docstring): a
    pending cut left by a crash is either finalized (already published —
    no retrain) or replayed from its durable spool (never published — no
    loss), bitwise-identical to the run that never crashed.

    ``step()`` is the deterministic unit (one poll, one cut if records
    arrived) — tests and soaks drive it directly; ``run(stop)`` is the
    production loop that cuts on the ``stream_micro_pass_s`` time budget
    with graceful backlog stretching.
    """

    def __init__(
        self,
        supervisor,
        stream_dir: str,
        date: str,
        pattern: str = "*",
        micro_pass_s: Optional[float] = None,
        poll_interval_s: Optional[float] = None,
        compact_every: Optional[int] = None,
        clock=time.monotonic,
        wall=time.time,
    ):
        if supervisor.checkpoint is None:
            raise ValueError(
                "StreamSupervisor needs a checkpointed PassSupervisor — "
                "the durable stream cursor lives under the checkpoint root"
            )
        self.sup = supervisor
        self.mgr = supervisor.checkpoint
        self.date = date
        self.clock = clock
        self.micro_pass_s = (
            float(config.get_flag("stream_micro_pass_s"))
            if micro_pass_s is None else float(micro_pass_s)
        )
        self.poll_interval_s = (
            float(config.get_flag("stream_poll_interval_s"))
            if poll_interval_s is None else float(poll_interval_s)
        )
        self.compact_every = (
            int(config.get_flag("stream_compact_every"))
            if compact_every is None else int(compact_every)
        )
        self.tailer = DirectoryTailer(stream_dir, pattern=pattern, wall=wall)
        self.cut_seq = 0
        self._stretch = 1.0
        self._recover()

    # ---- durable cursor --------------------------------------------------

    def _cursor_path(self) -> str:
        return os.path.join(self.mgr.root, STREAM_CURSOR_NAME)

    def _spool_rel(self, cut_seq: int) -> str:
        return os.path.join(SPOOL_DIR_NAME, f"cut-{cut_seq:06d}.txt")

    def read_cursor(self) -> Optional[Dict[str, Any]]:
        path = self._cursor_path()
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        # atomic_write publish: absent-or-torn reads as None, never garbage
        # pbox-lint: disable=EXC007
        except (OSError, ValueError):
            return None

    def _write_cursor(
        self, pending: Optional[Dict[str, Any]] = None
    ) -> None:
        cur = {
            "version": 1,
            "cut_seq": self.cut_seq,
            # always the COMMITTED positions: a pending cut's post-read
            # positions live inside the pending intent until it finalizes
            "files": self._committed_files,
            "pending": pending,
            "published": self._published_pos(),
        }
        with atomic_write(self._cursor_path()) as f:
            json.dump(cur, f)

    def _published_pos(self) -> Optional[Dict[str, Any]]:
        cur = self.mgr.cursor()
        if cur is None:
            return None
        return {"date": cur["date"], "delta_idx": int(cur["delta_idx"])}

    # ---- recovery --------------------------------------------------------

    def _recover(self) -> None:
        cur = self.read_cursor()
        if cur is None:
            self._committed_files: Dict[str, Any] = {}
            return
        self.cut_seq = int(cur.get("cut_seq", 0))
        self._committed_files = dict(cur.get("files") or {})
        # committed positions first: a discarded pending falls back to
        # them, and resume() proves nobody rewrote the consumed prefixes
        self.tailer.resume(self._committed_files)
        pending = cur.get("pending")
        if pending is None:
            return
        seq = int(pending["cut_seq"])
        spool = os.path.join(self.mgr.root, pending["spool"])
        spool_ok = (
            os.path.exists(spool)
            and _file_crc32(spool) == int(pending["spool_crc"])
        )
        if not spool_ok:
            # torn intent: the spool never became durable, so the cut never
            # logically happened — committed positions still point BEFORE
            # these records and the next poll re-reads the same bytes
            STAT_ADD("stream.pending_discarded")
            logger.warning(
                "stream: discarding torn pending cut %d (spool missing or "
                "CRC mismatch) — records will be re-read from the "
                "committed cursor", seq,
            )
            self._write_cursor(pending=None)
            return
        wm = self.mgr.read_watermark() or {}
        published_seq = int((wm.get("stream") or {}).get("cut_seq", 0))
        if published_seq >= seq:
            # the crash hit AFTER publish but before the cursor commit:
            # the records are already in the published chain — finalize
            # without retraining (zero duplicates)
            STAT_ADD("stream.replays_skipped")
            logger.info(
                "stream: pending cut %d already published (watermark at "
                "cut %d) — finalizing without retrain", seq, published_seq,
            )
            self._finalize(seq, pending["files"])
            return
        # the crash hit after the intent but before publish: replay the
        # SAME durable spool through the pass machinery (zero loss, and
        # bitwise-identical input to the run that never crashed)
        STAT_ADD("stream.replays")
        logger.info("stream: replaying pending cut %d from %s", seq, spool)
        self._train_publish(
            seq, spool,
            oldest_unix=pending.get("oldest_unix"),
            records=int(pending.get("records", 0)),
        )
        self._finalize(seq, pending["files"])

    def _finalize(self, seq: int, files: Dict[str, Any]) -> None:
        self.cut_seq = seq
        self._committed_files = dict(files)
        self.tailer.resume(self._committed_files)
        self._write_cursor(pending=None)
        self._gc_spools()

    # ---- cutting ---------------------------------------------------------

    def step(self) -> Optional[int]:
        """One poll; cut a micro-pass when complete records arrived.

        Returns the committed cut_seq, or None when the poll found
        nothing. This is the deterministic unit: a soak that drives
        ``step()`` per appended chunk is bitwise-comparable across
        kill/restart, independent of wall-clock cadence.
        """
        records, stamp = self.tailer.poll()
        if not records:
            return None
        return self._cut(records, stamp)

    def _cut(self, records: List[str], oldest_unix: float) -> int:
        seq = self.cut_seq + 1
        spool_rel = self._spool_rel(seq)
        spool = os.path.join(self.mgr.root, spool_rel)
        with atomic_write(spool) as f:
            f.write("\n".join(records) + "\n")
        pending = {
            "cut_seq": seq,
            "spool": spool_rel,
            "spool_crc": _file_crc32(spool),
            "files": self.tailer.snapshot_positions(),
            "oldest_unix": float(oldest_unix),
            "records": len(records),
        }
        self._write_cursor(pending=pending)
        _fault_fire("stream.cut_publish")  # window: intent durable, untrained
        self._train_publish(
            seq, spool, oldest_unix=oldest_unix, records=len(records)
        )
        _fault_fire("stream.cut_publish")  # window: published, cursor stale
        self._finalize(seq, pending["files"])
        STAT_ADD("stream.cuts")
        return seq

    def _train_publish(
        self, seq: int, spool: str, oldest_unix, records: int
    ) -> None:
        # stamped BEFORE the save so the watermark of this publish carries
        # the ingest floor of its oldest record (follower freshness SLO)
        self.mgr.stream_meta = {
            "cut_seq": seq,
            "oldest_unix": None if oldest_unix is None else float(oldest_unix),
            "records": int(records),
        }
        coord = self.sup.coord
        if coord is not None:
            ok, detail = stream_cut_round(coord, seq)
            if not ok:
                raise RuntimeError(f"stream cut {seq} aborted by a peer: {detail}")
        cur = self.mgr.cursor()
        # the stream date's first publish anchors a base; each later cut is
        # a minute-level delta. An elastic epoch flip re-anchors through the
        # supervisor (_force_base, MembershipEpochError): the cadence bends
        # and the stream resumes from the cursor
        mode = "base" if cur is None or cur["date"] != self.date else "delta"
        t0 = self.clock()
        self.sup.run_pass([spool], date=self.date, save=mode)
        STAT_OBSERVE("stream.cut_train_s", self.clock() - t0)
        if coord is not None:
            stream_confirm_round(coord, seq)
        self.maybe_compact()

    # ---- compaction ------------------------------------------------------

    def maybe_compact(self) -> Optional[str]:
        """Fold the chain when ``stream_compact_every`` deltas accumulated."""
        if self.compact_every <= 1:
            return None
        cur = self.mgr.cursor()
        if cur is None or cur["date"] != self.date:
            return None
        if int(cur.get("ownership_epoch", 0)) != int(self.mgr.ownership_epoch):
            return None  # mid-flip: the next cut re-anchors first
        behind = int(cur["delta_idx"]) - int(cur.get("compact") or 0)
        if behind < self.compact_every:
            return None
        table = self.sup.table
        scratch = HostSparseTable(
            table.layout, table.opt, n_shards=table.n_shards, seed=0
        )
        try:
            return self.mgr.compact(self.date, scratch)
        except MembershipEpochError:
            # an epoch flip landed between the cursor read and the fold:
            # the compact waits for the re-anchor, as a delta would
            STAT_ADD("stream.compact_deferred")
            return None

    # ---- production loop -------------------------------------------------

    def run(
        self,
        stop: threading.Event,
        max_cuts: Optional[int] = None,
        sleep=None,
    ) -> int:
        """Cut micro-passes on the time budget until ``stop`` is set.

        Collects tailed records for ``stream_micro_pass_s`` (polling every
        ``stream_poll_interval_s``), then cuts. A cut that overruns its
        window stretches the next one (doubling, capped at
        ``stream_backlog_max_stretch`` × budget, counted under
        ``stream.backlog_stretches``); windows shrink back once cuts run
        under half budget. Returns the number of cuts made.
        """
        sleep_fn = sleep if sleep is not None else stop.wait
        max_stretch = float(config.get_flag("stream_backlog_max_stretch"))
        cuts = 0
        backlog: List[str] = []
        oldest: Optional[float] = None
        while not stop.is_set():
            window = self.micro_pass_s * self._stretch
            deadline = self.clock() + window
            while self.clock() < deadline and not stop.is_set():
                recs, stamp = self.tailer.poll()
                if recs:
                    backlog.extend(recs)
                    if oldest is None:
                        oldest = stamp
                sleep_fn(
                    max(0.0, min(self.poll_interval_s,
                                 deadline - self.clock()))
                )
            if not backlog:
                continue
            t0 = self.clock()
            self._cut(backlog, oldest if oldest is not None else time.time())
            cut_cost = self.clock() - t0
            backlog, oldest = [], None
            cuts += 1
            if cut_cost > window:
                new = min(self._stretch * 2.0, max_stretch)
                if new > self._stretch:
                    STAT_ADD("stream.backlog_stretches")
                    logger.warning(
                        "stream: cut %d took %.2fs over a %.2fs window — "
                        "stretching cadence x%.1f", self.cut_seq, cut_cost,
                        window, new,
                    )
                self._stretch = new
            elif cut_cost < window / 2.0 and self._stretch > 1.0:
                self._stretch = max(1.0, self._stretch / 2.0)
            if max_cuts is not None and cuts >= max_cuts:
                break
        return cuts

    # ---- housekeeping ----------------------------------------------------

    def _gc_spools(self) -> None:
        """Retire spools older than the previous committed cut (keep one
        back, mirroring the dense-retire discipline)."""
        spool_dir = os.path.join(self.mgr.root, SPOOL_DIR_NAME)
        if not os.path.isdir(spool_dir):
            return
        keep = {f"cut-{s:06d}.txt" for s in (self.cut_seq, self.cut_seq - 1)}
        for name in os.listdir(spool_dir):
            if not name.startswith("cut-") or name in keep:
                continue
            try:
                os.remove(os.path.join(spool_dir, name))
            except OSError:
                # a leaked spool is disk creep, not a correctness problem
                # pbox-lint: disable=EXC007
                STAT_ADD("stream.spool_retire_failures")
