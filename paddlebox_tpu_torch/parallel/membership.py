"""Key-ownership epochs: explicit, versioned shard-range -> rank maps.

Port of the JAX package's ``parallel/membership.py``, the whole module
(pure numpy; its JSON and fingerprints are the JAX package's bytes). The
working set over several hosts (``table/dist_ws.py``) routes keys through
an :class:`OwnershipMap`; in the port a rank is one host-plane node, so
``OwnershipMap.even(world, world)`` gives rank ``r`` mesh shard ``r``.

The reference's closed ``boxps::MPICluster`` owns cluster membership: node
loss and key re-placement never surface in the open code. Our open rebuild
had membership frozen at construction — ownership was the *implicit*
arithmetic ``rank * shards_per_host`` in DistributedWorkingSet, carrier
splice pinning, trainer rank checks, and checkpoint shard naming — so a
dead peer killed the whole day. This module makes ownership an explicit,
versioned value:

- :class:`OwnershipMap` — contiguous shard ranges per live rank (largest-
  remainder apportionment, so ``n_mesh_shards % n_hosts`` need not be 0),
  stamped with an **ownership epoch** that bumps on every membership or
  placement change. Maps are value objects: ``shrink`` (drop dead ranks)
  and ``rebalance`` (same ranks, new boundaries) return new maps at
  epoch+1; every rank derives the identical successor map from the same
  inputs, so during steady state no map needs to ride the wire.
- :func:`agree_membership` — the survivor verdict round. The proposed dead
  set is encoded in the collective TAG itself: completing an allgather on
  ``ctl:member:<seq>:<dead>`` proves every live rank proposed exactly that
  set (ranks with divergent views fail into PeerDeadError, union the new
  evidence, and re-enter with the bigger set — convergence is bounded by
  the rank count).
- :func:`sync_map` — the map-base agreement that follows: survivors
  allgather their CURRENT map and every rank adopts the highest-epoch one.
  A rank whose membership round was interrupted mid-install (a second
  death) re-enters one map behind its peers; without this round each side
  would derive a successor from a different base — same epoch number,
  different boundaries — and the epoch checks could never tell. Two maps
  at the same epoch with different content are split-brain and raise.
- :func:`adopt_dead_shards` — a survivor pulls the shard ranges it gained
  from the dead rank's last manifest-verified checkpoint (the CRC-verified
  resume path) into its own live table. Pure upsert: a retry
  after a mid-adopt crash lands bitwise-identical rows. When the dead
  chain's recorded ownership epoch predates the current map — the rank
  died before its post-flip re-anchor save landed — the ranges it gained
  in that flip are filled from the PREVIOUS owners' chains (``prev_map``):
  a flip is base-saved before any training resumes, so a stale chain
  means no pass confirmed since the flip and the previous owner's durable
  copy is bitwise the boundary state.
- :func:`plan_rebalance` / :func:`plan_moves` / shard-row wire codec — the
  planned-migration half: boundaries recut at cumulative-load quantiles,
  moving ranges streamed owner->owner over PBTX v3 (codec-framed, CRC'd,
  epoch-tagged so stale frames are unreceivable), both sides flipping to
  the new epoch atomically at a pass boundary.

Ownership filtering is the correctness backbone: keys are only ever READ
through the current map (exchange routing, writeback, digests, adoption),
so a stale copy left behind on a migration source or a dead rank's disk is
unreachable — no tombstones, no deletion protocol (see docs/ROBUSTNESS.md,
"Elastic membership & key migration").
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.parallel.transport import PeerDeadError
from paddlebox_tpu_torch.utils.faultinject import fire
from paddlebox_tpu_torch.utils.monitor import STAT_ADD


def apportion(n_items: int, n_parts: int) -> List[int]:
    """Largest-remainder contiguous split: the first ``n_items % n_parts``
    parts get the ceiling, the rest the floor. Reproduces the old even
    split exactly when divisible."""
    if n_parts <= 0:
        raise ValueError(f"cannot apportion over {n_parts} parts")
    base, rem = divmod(int(n_items), int(n_parts))
    return [base + 1 if i < rem else base for i in range(n_parts)]


class OwnershipMap:
    """Versioned map: contiguous mesh-shard ranges -> live ranks.

    ``starts`` has ``len(live_ranks) + 1`` monotone boundaries with
    ``starts[0] == 0`` and ``starts[-1] == n_mesh_shards``; live rank
    ``live_ranks[i]`` owns shards ``[starts[i], starts[i+1])`` (possibly
    empty). Immutable by convention: membership/placement changes go
    through :meth:`shrink` / :meth:`rebalance`, which bump ``epoch``.
    """

    __slots__ = ("n_mesh_shards", "live_ranks", "starts", "epoch")

    def __init__(
        self,
        n_mesh_shards: int,
        live_ranks: Iterable[int],
        starts: Sequence[int],
        epoch: int = 0,
    ):
        live = tuple(sorted(int(r) for r in live_ranks))
        bounds = tuple(int(s) for s in starts)
        if not live:
            raise ValueError("ownership map needs at least one live rank")
        if len(set(live)) != len(live):
            raise ValueError(f"duplicate ranks in live set {live}")
        if len(bounds) != len(live) + 1:
            raise ValueError(
                f"{len(live)} live ranks need {len(live) + 1} boundaries, "
                f"got {len(bounds)}"
            )
        if bounds[0] != 0 or bounds[-1] != int(n_mesh_shards):
            raise ValueError(
                f"boundaries {bounds} must span [0, {n_mesh_shards}]"
            )
        if any(b > a for a, b in zip(bounds[1:], bounds)):
            raise ValueError(f"boundaries {bounds} must be non-decreasing")
        self.n_mesh_shards = int(n_mesh_shards)
        self.live_ranks = live
        self.starts = bounds
        self.epoch = int(epoch)

    # ---- construction ----------------------------------------------------

    @classmethod
    def even(cls, n_mesh_shards: int, n_ranks: int, epoch: int = 0) -> "OwnershipMap":
        """Canonical largest-remainder split over ranks 0..n_ranks-1."""
        return cls.even_over(n_mesh_shards, range(n_ranks), epoch)

    @classmethod
    def even_over(
        cls, n_mesh_shards: int, ranks: Iterable[int], epoch: int = 0
    ) -> "OwnershipMap":
        """Largest-remainder split over an arbitrary live set — the
        initial map of a fleet smaller than its endpoint list (slots
        reserved for future joiners)."""
        live = sorted(int(r) for r in ranks)
        counts = apportion(n_mesh_shards, len(live))
        starts = [0]
        for c in counts:
            starts.append(starts[-1] + c)
        return cls(n_mesh_shards, live, starts, epoch)

    def shrink(self, dead: Iterable[int]) -> "OwnershipMap":
        """Successor map without ``dead``, epoch bumped. Deterministic —
        every rank derives the same map from the same inputs.

        Minimal movement by design: every survivor KEEPS its exact range,
        and each dead gap is split at its midpoint between the flanking
        survivors (a leading gap goes wholly to the first survivor, a
        trailing gap to the last). So the only shard ranges that change
        owner came from dead ranks — the checkpoint-adoption path covers
        every move, and no live-to-live state transfer is ever needed
        during a death. Load skew a shrink introduces is the planned
        migration path's job to fix at a later pass boundary."""
        gone = set(int(d) for d in dead)
        survivors = [r for r in self.live_ranks if r not in gone]
        if not survivors:
            raise ValueError(f"shrinking {self.live_ranks} by {sorted(gone)} leaves no ranks")
        ranges = [self.range_of(r) for r in survivors]
        starts = [0]
        for (_, prev_hi), (nxt_lo, _) in zip(ranges, ranges[1:]):
            starts.append((prev_hi + nxt_lo) // 2)
        starts.append(self.n_mesh_shards)
        return OwnershipMap(self.n_mesh_shards, survivors, starts, self.epoch + 1)

    def rebalance(self, starts: Sequence[int]) -> "OwnershipMap":
        """Successor map with the same live set and new boundaries."""
        return OwnershipMap(self.n_mesh_shards, self.live_ranks, starts, self.epoch + 1)

    def grow(self, joiner: int, shard_loads=None) -> "OwnershipMap":
        """Successor map WITH ``joiner``, epoch bumped — the dual of
        :meth:`shrink`. Deterministic from (map, joiner, loads): every
        rank derives the identical successor, so only the decision to
        admit rides the wire, never the map itself.

        Minimal movement by design: only the joiner's flanking neighbors
        in rank order cede shards — every other survivor KEEPS its exact
        range, so the only live-to-live transfers a join ever needs are
        flank -> joiner, streamed through the existing stage-then-commit
        ``migrate_ranges`` path. The carve is hot-load-aware rather than
        key-count-aware: the combined flanking window is recut at
        cumulative-load quantiles (the :func:`plan_rebalance` sweep
        applied to the neighborhood), so the joiner takes the load-heavy
        middle of its neighborhood and the flanks keep balanced rims.
        ``shard_loads`` is a length-``n_mesh_shards`` hotness/occupancy
        vector (the supervisor feeds decayed show counts + tier
        occupancy); None or all-zero falls back to a uniform carve."""
        j = int(joiner)
        if j < 0:
            raise ValueError(f"joiner rank {j} must be >= 0")
        if j in self.live_ranks:
            raise ValueError(f"rank {j} is already live in {self!r}")
        if shard_loads is None:
            loads = np.ones(self.n_mesh_shards, dtype=np.float64)
        else:
            loads = np.asarray(shard_loads, dtype=np.float64)
            if len(loads) != self.n_mesh_shards:
                raise ValueError(
                    f"need {self.n_mesh_shards} shard loads, got {len(loads)}"
                )
        live = sorted(self.live_ranks + (j,))
        i = live.index(j)
        left = live[i - 1] if i > 0 else None
        right = live[i + 1] if i + 1 < len(live) else None
        # the carve window: the flanking survivors' combined contiguous
        # range (one flank when the joiner lands at either end)
        win_lo = self.range_of(left)[0] if left is not None else self.range_of(right)[0]
        win_hi = self.range_of(right)[1] if right is not None else self.range_of(left)[1]
        parts = [r for r in (left, j, right) if r is not None]
        cuts = [win_lo]
        if win_hi > win_lo:
            wloads = loads[win_lo:win_hi]
            if float(wloads.sum()) <= 0:
                wloads = np.ones(win_hi - win_lo, dtype=np.float64)
            wtotal = float(wloads.sum())
            cum = np.cumsum(wloads)
            for k in range(1, len(parts)):
                rel = int(
                    np.searchsorted(cum, wtotal * k / len(parts), side="left")
                ) + 1
                cut = win_lo + rel
                if win_hi - win_lo >= len(parts):
                    # load mass piled at either edge of the window must not
                    # starve a part into an empty range: when the window is
                    # wide enough, every part (joiner included) lands at
                    # least one shard
                    cut = min(max(cut, win_lo + k), win_hi - (len(parts) - k))
                cuts.append(min(max(cut, cuts[-1]), win_hi))
        else:
            # zero-width window (flanks own nothing): the joiner starts
            # empty and the planned-migration path fills it in later
            cuts.extend([win_lo] * (len(parts) - 1))
        cuts.append(win_hi)
        ranges = {
            r: self.range_of(r)
            for r in self.live_ranks
            if r != left and r != right
        }
        for part_rank, lo, hi in zip(parts, cuts, cuts[1:]):
            ranges[part_rank] = (lo, hi)
        starts = [ranges[r][0] for r in live]
        starts.append(self.n_mesh_shards)
        return OwnershipMap(self.n_mesh_shards, live, starts, self.epoch + 1)

    # ---- queries ---------------------------------------------------------

    def is_live(self, rank: int) -> bool:
        return int(rank) in self.live_ranks

    def range_of(self, rank: int) -> Tuple[int, int]:
        """[lo, hi) shard range this rank owns."""
        i = self.live_ranks.index(int(rank))
        return self.starts[i], self.starts[i + 1]

    def n_owned(self, rank: int) -> int:
        lo, hi = self.range_of(rank)
        return hi - lo

    def owner_of_shard(self, shards) -> np.ndarray:
        """Vectorized shard -> owning rank (int64 array)."""
        s = np.asarray(shards, dtype=np.int64)
        inner = np.asarray(self.starts[1:], dtype=np.int64)
        idx = np.searchsorted(inner, s, side="right")
        return np.asarray(self.live_ranks, dtype=np.int64)[idx]

    # ---- value semantics / wire form ------------------------------------

    def fingerprint(self) -> str:
        """Short content hash over boundaries + live set + epoch. Rides in
        verdict tags so two ranks holding divergent maps (same epoch,
        different boundaries) stall loudly instead of committing a
        split-brain flip."""
        import zlib as _zlib

        return f"{_zlib.crc32(self.to_json().encode()):08x}"

    def to_json(self) -> str:
        return json.dumps(
            {
                "n_mesh_shards": self.n_mesh_shards,
                "live_ranks": list(self.live_ranks),
                "starts": list(self.starts),
                "epoch": self.epoch,
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, blob: str) -> "OwnershipMap":
        d = json.loads(blob)
        return cls(d["n_mesh_shards"], d["live_ranks"], d["starts"], d["epoch"])

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, OwnershipMap)
            and self.n_mesh_shards == other.n_mesh_shards
            and self.live_ranks == other.live_ranks
            and self.starts == other.starts
            and self.epoch == other.epoch
        )

    def __hash__(self):
        return hash((self.n_mesh_shards, self.live_ranks, self.starts, self.epoch))

    def __repr__(self) -> str:
        return (
            f"OwnershipMap(epoch={self.epoch}, live={list(self.live_ranks)}, "
            f"starts={list(self.starts)})"
        )


# ---- membership verdict round -------------------------------------------


def agree_membership(
    transport, seq, timeout: Optional[float] = None
) -> List[int]:
    """Converge every survivor on one dead-rank set; returns it sorted.

    The proposal rides in the tag: an allgather on
    ``ctl:member:<seq>:<dead>`` completes only when every transport-live
    rank sent a frame under exactly that tag — i.e. proposed exactly that
    dead set. A survivor with extra evidence is, from this rank's view, a
    rank that died mid-round (its frame never arrives, the detector fires)
    — the PeerDeadError's ``dead`` list IS the missing evidence, so the
    proposal unions it and re-enters. Convergence is bounded by the rank
    count: each retry strictly grows the dead set.

    Tags carry no ``@e`` suffix on purpose: the pass-epoch discard floor
    advances during the death handling itself, and membership control
    frames must survive it.
    """
    for _ in range(transport.n_ranks + 1):
        dead = sorted(transport.dead_peers())
        name = ",".join(str(d) for d in dead) if dead else "-"
        try:
            transport.allgather(b"", f"ctl:member:{seq}:{name}", timeout=timeout)
            return dead
        except PeerDeadError as e:
            transport.mark_dead(e.dead)
    raise PeerDeadError(
        f"rank {transport.rank}: membership agreement for seq {seq!r} did "
        f"not converge within {transport.n_ranks + 1} rounds",
        sorted(transport.dead_peers()),
    )


def sync_map(
    transport,
    seq,
    dead: Sequence[int],
    my_map: OwnershipMap,
    timeout: Optional[float] = None,
) -> OwnershipMap:
    """Converge every survivor on one base map before deriving a successor.

    Survivors allgather their CURRENT map (the one wire-crossing a map
    ever does) and adopt the highest-epoch one: a rank whose previous
    membership round was cut short by a second death re-enters one map
    behind its peers, and shrinking divergent bases would yield maps with
    the SAME epoch but DIFFERENT boundaries — undetectable by the epoch
    checks. The tag embeds the agreed dead set, so this round only runs
    between ranks that already converged in :func:`agree_membership`.
    Raises on two same-epoch maps with different content (split-brain —
    the migrate commit verdict is built to make this impossible).
    """
    name = ",".join(str(d) for d in sorted(dead)) if dead else "-"
    views = transport.allgather(
        my_map.to_json().encode(), f"ctl:mapsync:{seq}:{name}", timeout=timeout
    )
    best = my_map
    for v in views:
        if not v:
            continue  # membership-dead slots contribute b"" placeholders
        m = OwnershipMap.from_json(v.decode())
        if m.epoch > best.epoch:
            best = m
        elif m.epoch == best.epoch and m != best:
            raise RuntimeError(
                f"rank {transport.rank}: ownership split-brain — two maps "
                f"at epoch {m.epoch} with different boundaries: {best!r} "
                f"vs {m!r}"
            )
    return best


# ---- adoption (failure path) --------------------------------------------


def adopt_dead_shards(
    table,
    shared_root: str,
    dead_rank: int,
    old_map: OwnershipMap,
    new_map: OwnershipMap,
    my_rank: int,
    prev_map: Optional[OwnershipMap] = None,
) -> int:
    """Pull the shard range this rank gained from ``dead_rank``'s last
    manifest-verified checkpoint into ``table``; returns keys adopted.

    The source is the dead rank's own per-rank checkpoint root
    (:func:`paddlebox_tpu_torch.train.checkpoint.rank_root`), replayed through
    the CRC-verified resume path into a scratch table, then filtered to
    the shards that moved to this rank. ``table.push`` is an upsert, so a
    crash mid-adopt retried lands bitwise-identical (FLT008 contract —
    fault site ``membership.adopt_shard``). A dead rank that never
    checkpointed (death before the first base save) adopts zero keys: the
    retried pass recreates them from the seeded deterministic init, which
    is exactly what a fresh shrunk-membership run does.

    ``prev_map`` (the map the LAST flip replaced, recorded by the
    supervisor at install time) closes the residual durability window:
    when the dead chain's recorded ownership epoch predates ``old_map``'s
    — the rank died during its own post-flip re-anchor save — the ranges
    it gained in that flip are absent from (or stale leftovers in) its
    chain. Because every flip base-saves before training resumes, a stale
    chain implies no pass confirmed since the flip, so the PREVIOUS
    owners' durable chains hold the exact boundary state; those pieces
    are filled from them, overwriting any frozen leftover copies the dead
    chain contributed.
    """
    from paddlebox_tpu_torch.table.sparse_table import HostSparseTable, key_to_shard
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager, rank_root

    dead_lo, dead_hi = old_map.range_of(dead_rank)
    my_lo, my_hi = new_map.range_of(my_rank)
    lo, hi = max(dead_lo, my_lo), min(dead_hi, my_hi)
    if lo >= hi:
        return 0
    scratch = HostSparseTable(table.layout, table.opt, n_shards=table.n_shards, seed=0)
    ck = CheckpointManager(rank_root(shared_root, dead_rank))
    state = ck.resume(scratch)
    # -1 marks a cold chain: strictly older than any real epoch, so the
    # fallback below also covers a rank that died before its FIRST save
    # but after gaining ranges in a flip
    chain_epoch = -1 if state is None else int(state.get("ownership_epoch", 0))
    keys = np.zeros(0, dtype=np.uint64)
    if state is not None:
        keys = scratch.keys()
        shards = key_to_shard(keys, new_map.n_mesh_shards)
        keys = np.sort(keys[(shards >= lo) & (shards < hi)])
    fire("membership.adopt_shard")
    if len(keys):
        table.push(keys, scratch.pull_or_create(keys))
    n = int(len(keys))
    if prev_map is not None and chain_epoch < old_map.epoch:
        for prev_owner in prev_map.live_ranks:
            plo, phi = prev_map.range_of(prev_owner)
            plo, phi = max(plo, lo), min(phi, hi)
            if plo >= phi or int(prev_owner) == int(dead_rank):
                # the piece the dead rank ALREADY owned at its chain epoch
                # is authoritatively covered by its own chain above
                continue
            fb = HostSparseTable(
                table.layout, table.opt, n_shards=table.n_shards, seed=0
            )
            src = CheckpointManager(rank_root(shared_root, prev_owner))
            if src.resume(fb) is None:
                continue
            fkeys = fb.keys()
            fsh = key_to_shard(fkeys, new_map.n_mesh_shards)
            fkeys = np.sort(fkeys[(fsh >= plo) & (fsh < phi)])
            fire("membership.adopt_shard")
            if len(fkeys):
                # overwrite: within this piece the previous owner's chain
                # is fresher than anything the stale dead chain held
                table.push(fkeys, fb.pull_or_create(fkeys))
            n += int((~np.isin(fkeys, keys)).sum())
            STAT_ADD("membership.adopt_fallbacks")
    STAT_ADD("membership.adopts")
    STAT_ADD("membership.adopted_keys", n)
    return n


# ---- planned migration (boundary path) ----------------------------------

# shard-row transfer header: n_keys, row width (floats)
_XFER = struct.Struct("<QI")


def encode_shard_rows(keys: np.ndarray, rows: np.ndarray) -> bytes:
    """Wire form of a moving key range: header + sorted uint64 keys +
    float32 rows. Rides a PBTX v3 data frame, so codec framing, CRC32 and
    epoch tagging come from the transport."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    width = rows.shape[1] if rows.ndim == 2 else 0
    return _XFER.pack(len(keys), width) + keys.tobytes() + rows.tobytes()


def decode_shard_rows(payload: bytes) -> Tuple[np.ndarray, np.ndarray]:
    n, width = _XFER.unpack_from(payload)
    off = _XFER.size
    keys = np.frombuffer(payload, dtype=np.uint64, count=n, offset=off)
    rows = np.frombuffer(
        payload, dtype=np.float32, count=n * width, offset=off + n * 8
    ).reshape(n, width)
    return keys, rows


def plan_rebalance(
    omap: OwnershipMap, shard_loads: np.ndarray, skew_threshold: float
) -> Optional[OwnershipMap]:
    """Propose a successor map when per-rank load skew crosses the
    threshold; None when balanced enough or no load. Boundaries are recut
    at cumulative-load quantiles (contiguous weighted apportionment, the
    sweep-apportion idea applied to rows instead of shards). Deterministic
    from ``shard_loads`` — every rank holding the same global load vector
    derives the identical plan."""
    loads = np.asarray(shard_loads, dtype=np.float64)
    if len(loads) != omap.n_mesh_shards:
        raise ValueError(
            f"need {omap.n_mesh_shards} shard loads, got {len(loads)}"
        )
    total = float(loads.sum())
    n_live = len(omap.live_ranks)
    if total <= 0 or n_live < 2:
        return None
    per_rank = np.array(
        [float(loads[lo:hi].sum()) for lo, hi in
         (omap.range_of(r) for r in omap.live_ranks)]
    )
    mean = total / n_live
    if mean <= 0 or float(per_rank.max()) / mean < skew_threshold:
        return None
    cum = np.cumsum(loads)
    starts = [0]
    for i in range(1, n_live):
        cut = int(np.searchsorted(cum, total * i / n_live, side="left")) + 1
        cut = max(cut, starts[-1])
        cut = min(cut, omap.n_mesh_shards)
        starts.append(cut)
    starts.append(omap.n_mesh_shards)
    if tuple(starts) == omap.starts:
        return None
    return omap.rebalance(starts)


def plan_moves(
    old_map: OwnershipMap, new_map: OwnershipMap
) -> List[Tuple[int, int, int, int]]:
    """Shard ranges whose owner changes between two maps over the same
    shard space: ``(lo, hi, src_rank, dst_rank)`` per contiguous piece.
    Only live-in-both src ranks appear (a dead src is the adoption path,
    not a migration)."""
    if old_map.n_mesh_shards != new_map.n_mesh_shards:
        raise ValueError("maps cover different shard spaces")
    bounds = sorted(set(old_map.starts) | set(new_map.starts))
    moves = []
    for lo, hi in zip(bounds, bounds[1:]):
        if lo >= hi:
            continue
        src = int(old_map.owner_of_shard([lo])[0])
        dst = int(new_map.owner_of_shard([lo])[0])
        if src != dst and new_map.is_live(src):
            moves.append((lo, hi, src, dst))
    return moves


def migrate_ranges(
    transport,
    table,
    old_map: OwnershipMap,
    new_map: OwnershipMap,
    seq,
    epoch: int,
    timeout: Optional[float] = None,
) -> Dict[str, int]:
    """Stream every moving shard range owner -> owner; returns stats.

    Senders encode (keys, rows) for each outgoing piece and ship it on an
    epoch-tagged PBTX frame (``migrate:<seq>:<lo>-<hi>@e<epoch>``), firing
    fault site ``migrate.transfer`` per piece; receivers STAGE incoming
    pieces and only push them after the caller's commit verdict succeeds —
    the staged dict is returned inside ``stats["staged"]`` so the caller
    (the supervisor's boundary hook) controls the atomic flip. Until then
    the old epoch keeps serving; a failed plan is simply retried at the
    next boundary (FLT008 contract for ``migrate.transfer``).
    """
    from paddlebox_tpu_torch.table.sparse_table import key_to_shard

    me = transport.rank
    moves = plan_moves(old_map, new_map)
    sent_bytes = 0
    sent_keys = 0
    for lo, hi, src, dst in moves:
        if src != me:
            continue
        keys = np.sort(table.keys())
        shards = key_to_shard(keys, old_map.n_mesh_shards)
        keys = keys[(shards >= lo) & (shards < hi)]
        rows = (
            table.pull_or_create(keys)
            if len(keys)
            else np.zeros((0, table.layout.width), np.float32)
        )
        fire("migrate.transfer")
        payload = encode_shard_rows(keys, rows)
        transport.send(dst, f"migrate:{seq}:{lo}-{hi}@e{epoch}", payload)
        sent_bytes += len(payload)
        sent_keys += len(keys)
    staged: List[Tuple[np.ndarray, np.ndarray]] = []
    recv_keys = 0
    for lo, hi, src, dst in moves:
        if dst != me:
            continue
        payload = transport.recv(
            f"migrate:{seq}:{lo}-{hi}@e{epoch}", src, timeout=timeout
        )
        keys, rows = decode_shard_rows(payload)
        staged.append((keys, rows))
        recv_keys += len(keys)
    return {
        "moves": len(moves),
        "sent_keys": sent_keys,
        "sent_bytes": sent_bytes,
        "recv_keys": recv_keys,
        "staged": staged,
    }


def commit_staged(table, staged) -> int:
    """Push staged migration pieces into the live table (upsert). Called
    only after the commit verdict — the atomic-flip half of migration."""
    n = 0
    for keys, rows in staged:
        if len(keys):
            table.push(keys, rows)
            n += len(keys)
    return n
