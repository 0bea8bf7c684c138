"""Multi-host pass working set: host-sharded table ownership + key exchange.

Port of the JAX package's ``table/dist_ws.py``. The port runs one process
a card, so a host is one mesh rank: ``OwnershipMap.even(world, world)``
gives rank ``r`` mesh shard ``r`` (``shards_per_host`` 1), and
``finalize`` returns that rank's block ``[1, cap, width]``. The layout
depends only on ``n_mesh_shards`` and the keys, never on how many hosts
share them, so it is the single-process ``PassWorkingSet``'s exactly.

The reference's pass open (`BeginFeedPass`, box_wrapper.cc:580) hands every
feasign of the pass to the closed boxps lib, which shards keys across MPI
nodes and stages each node's slice into its GPUs. This module is that tier
in the open: mesh shards partition keys (`key_to_shard(key, n_mesh)`), each
host OWNS the contiguous shard range of its local devices, and a two-round
host exchange builds the pass:

  round 1 (request):  every host all-to-alls the pass keys it saw to the
                      keys' owner hosts;
  round 2 (reply):    each owner dedups, assigns ranks (ascending key order
                      per shard — identical layout to the single-process
                      PassWorkingSet), pulls/creates rows in its LOCAL
                      HostSparseTable slice, and replies to each requester
                      with the global row ids of the keys it asked about.

Capacity is allreduce-max'd so every host builds the same shapes
(lockstep parity, compute_thread_batch_nccl data_set.cc:2069-2135), and
writeback is purely local: a host's trained device slice lands in its own
host table — no cross-host traffic at pass end.

Both rounds encode through ``ops/host_codec.py``: request key streams are
delta+varint under the ``host_wire_codec`` flag (sorted unique uint64 →
~1-2 bytes/key; marker byte keeps raw/codec ranks interoperable), and row
replies always ride the narrow-int codec (width picked from the
``n_mesh_shards * capacity`` bound, overflow is a loud codec error).
``wire.ws_req_*`` / ``wire.ws_rep_*`` counters record raw-vs-encoded bytes
per round.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from paddlebox_tpu_torch import config
from paddlebox_tpu_torch.ops import host_codec
from paddlebox_tpu_torch.parallel.membership import OwnershipMap
from paddlebox_tpu_torch.table.sparse_table import (
    HostSparseTable,
    key_to_shard,
    merge_unique_keys,
)
from paddlebox_tpu_torch.utils.monitor import STAT_ADD


class DistributedWorkingSet:
    """Pass working set across hosts; same pack-time surface as
    PassWorkingSet (n_mesh_shards / capacity / padding_row / lookup)."""

    def __init__(
        self, transport, n_mesh_shards: int, pass_id: int = 0, epoch: int = 0,
        ownership: Optional[OwnershipMap] = None,
    ):
        self.transport = transport
        self.n_mesh_shards = n_mesh_shards
        n_hosts = transport.n_ranks
        # ownership is an explicit versioned map (largest-remainder
        # contiguous ranges), not rank arithmetic: uneven splits are fine
        # and the live set may be smaller than the endpoint list after a
        # membership shrink. Default reproduces the historical even split.
        if ownership is None:
            ownership = OwnershipMap.even(n_mesh_shards, n_hosts)
        if ownership.n_mesh_shards != n_mesh_shards:
            raise ValueError(
                f"ownership map covers {ownership.n_mesh_shards} shards, "
                f"pass has {n_mesh_shards}"
            )
        if not ownership.is_live(transport.rank):
            raise ValueError(
                f"rank {transport.rank} is not live in {ownership!r}"
            )
        self.ownership = ownership
        lo, hi = ownership.range_of(transport.rank)
        self.shard_lo = lo
        self.shards_per_host = hi - lo  # THIS rank's owned count (uneven ok)
        self.pass_id = pass_id
        # pass-retry epoch: tags carry ``@e<epoch>`` so the transport can
        # discard a reverted attempt's frames instead of feeding them to
        # the retried exchange (see TcpTransport.discard_epochs_below)
        self.epoch = epoch
        self._key_chunks: List[np.ndarray] = []
        self._lock = threading.Lock()
        self._finalized = False
        # set by finalize():
        self.sorted_keys: Optional[np.ndarray] = None  # referenced keys
        self.row_of_sorted: Optional[np.ndarray] = None
        self.capacity = 0
        self.n_keys = 0  # locally referenced
        self.owned_shard_keys: Optional[List[np.ndarray]] = None
        # bool [n_mesh_shards*capacity] hotness bits for the adaptive ICI
        # wire (None = off/ablated); set by finalize via the gated ws-hot
        # round — owners read their local tier, requesters get one bit per
        # requested key
        self.hot_rows: Optional[np.ndarray] = None
        self.exchange_s = 0.0

    def add_keys(self, keys: np.ndarray) -> None:
        if self._finalized:
            raise RuntimeError("working set already finalized")
        if len(keys):
            with self._lock:
                self._key_chunks.append(np.unique(keys.astype(np.uint64)))

    def premerge(self, threads: int = 1) -> np.ndarray:
        """Collapse accumulated key chunks now (boundary feed stage); the
        later finalize re-merges the singleton list via the no-copy fast
        path (see PassWorkingSet.premerge)."""
        if self._finalized:
            raise RuntimeError("working set already finalized")
        with self._lock:
            merged = merge_unique_keys(self._key_chunks, threads)
            self._key_chunks = [merged] if len(merged) else []
        return merged

    def _owner_host(self, keys: np.ndarray) -> np.ndarray:
        return self.ownership.owner_of_shard(
            key_to_shard(keys, self.n_mesh_shards)
        )

    def finalize(
        self, table: HostSparseTable, round_to: int = 512, carrier=None,
        prefetch=None,
    ) -> np.ndarray:
        """Two-round exchange; returns THIS host's device slice
        ``[shards_per_host, capacity, width]`` (global row of key =
        global_shard * capacity + rank, exactly the single-process layout).

        With ``carrier`` (a MultiHostCarrier from the previous pass's
        end_pass), the boundary goes delta-only PER HOST: the rank's card
        splices its surviving shard rows, departures go device to host
        only for their slice into the local host table, and only new keys
        upload, without any cross-host traffic (every node keeps its
        device cache warm, EndPass parity box_wrapper.cc:627-651). Returns
        the block as a tensor on the carrier's device in that case.

        ``exchange_s`` holds the wall seconds of this call's host-plane
        rounds (the key requests, the capacity all-reduce, the row
        replies and, when engaged, the hotness round).

        ``prefetch`` is accepted for interface parity with
        PassWorkingSet.finalize and ignored: the dataset's boundary feed
        stage never stages a host prefetch for a distributed pass (owned
        keys are only known after the exchange)."""
        t = self.transport
        with self._lock:
            referenced = merge_unique_keys(
                self._key_chunks,
                int(config.get_flag("boundary_merge_threads")),
            )
            self._key_chunks = []
        self.n_keys = len(referenced)

        # round 1: route referenced keys to their owner hosts. The keys per
        # destination are a masked slice of np.unique output — sorted — so
        # the delta+varint codec applies; the payload's marker byte keeps
        # the format self-describing (a codec-on rank and a raw-ablation
        # rank decode each other's frames identically)
        use_codec = bool(config.get_flag("host_wire_codec"))
        owners = self._owner_host(referenced)
        req_out = []
        for h in range(t.n_ranks):
            req_out.append(
                host_codec.encode_key_stream(referenced[owners == h], use_codec)
            )
        STAT_ADD("wire.ws_req_raw_bytes", int(len(referenced)) * 8)
        STAT_ADD("wire.ws_req_bytes", sum(len(b) for b in req_out))
        t_x = time.perf_counter()
        req_in = t.alltoall(req_out, f"ws-req:{self.pass_id}@e{self.epoch}")
        self.exchange_s = time.perf_counter() - t_x
        # ranks outside the ownership live set contribute b"" placeholder
        # slots (membership-aware alltoall), never decodable payloads
        live = set(self.ownership.live_ranks)
        req_keys = [
            host_codec.decode_key_stream(b) if h in live
            else np.zeros(0, np.uint64)
            for h, b in enumerate(req_in)
        ]

        # owner side: union, per-shard rank assignment (ascending key order)
        owned = (
            np.unique(np.concatenate([k for k in req_keys]))
            if any(len(k) for k in req_keys)
            else np.zeros(0, np.uint64)
        )
        shard_of = key_to_shard(owned, self.n_mesh_shards) - self.shard_lo
        counts = np.bincount(shard_of, minlength=self.shards_per_host)
        local_max = int(counts.max()) + 1 if len(owned) else 1
        t_x = time.perf_counter()
        cap = t.allreduce_max(local_max, f"ws-cap:{self.pass_id}@e{self.epoch}")
        self.exchange_s += time.perf_counter() - t_x
        cap = -(-cap // round_to) * round_to
        self.capacity = cap

        order = np.argsort(shard_of, kind="stable")  # keys sorted => rank order
        rank_in_shard = np.empty(len(owned), dtype=np.int64)
        starts = np.repeat(np.cumsum(counts) - counts, counts)
        rank_in_shard[order] = np.arange(len(owned), dtype=np.int64) - starts
        self.owned_shard_keys = np.split(
            owned[order], np.cumsum(counts)[:-1]
        )
        owned_rows = (
            (key_to_shard(owned, self.n_mesh_shards)) * cap + rank_in_shard
        )

        # build the local device slice: spliced from the carried device
        # table when one is live, else classic pull from the local host
        # table
        self.boundary_stats = None
        same_epoch = carrier is None or (
            getattr(carrier, "ownership_epoch", 0) == self.ownership.epoch
        )
        if carrier is not None and same_epoch and not carrier.flushed and len(owned):
            dev = self._finalize_spliced(table, carrier, cap)
        else:
            if carrier is not None:
                # no splice possible (empty pass, already flushed, or the
                # carrier's shard->host pinning predates this ownership
                # epoch): everything the carrier owes must land before the
                # classic pull reads host rows
                table.drain_pending()
            vals = (
                table.pull_or_create(owned)
                if len(owned)
                else np.zeros((0, table.layout.width), np.float32)
            )
            dev = np.zeros(
                (self.shards_per_host, cap, table.layout.width), np.float32
            )
            if len(owned):
                # guarded: reshape(0, -1) on a zero-width ownership range
                # cannot infer the trailing dim
                local_rows = shard_of * cap + rank_in_shard
                dev.reshape(self.shards_per_host * cap, -1)[local_rows] = vals

        # round 2: reply global rows for each requester's keys (their
        # order). Rows are shard*cap+rank, bounded by n_mesh_shards*cap —
        # the narrow-int codec downcasts to the width that bound needs
        # (uint16/uint32 in practice, never int64) and raises on overflow.
        # Always on, raw ablation included: the width byte self-describes.
        max_row = self.n_mesh_shards * cap - 1
        rep_out = []
        pos_all = np.searchsorted(owned, np.concatenate(req_keys)) if len(owned) else None
        off = 0
        for h in range(t.n_ranks):
            k = req_keys[h]
            if len(k):
                rep_out.append(
                    host_codec.encode_row_ids(
                        owned_rows[pos_all[off : off + len(k)]], max_row
                    )
                )
            else:
                rep_out.append(host_codec.encode_row_ids(np.zeros(0, np.int64), max_row))
            off += len(k)
        STAT_ADD(
            "wire.ws_rep_raw_bytes",
            8 * sum(len(k) for k in req_keys),
        )
        STAT_ADD("wire.ws_rep_bytes", sum(len(b) for b in rep_out))
        t_x = time.perf_counter()
        rep_in = t.alltoall(rep_out, f"ws-rep:{self.pass_id}@e{self.epoch}")
        self.exchange_s += time.perf_counter() - t_x

        # assemble local lookup over referenced keys; non-live slots carry
        # no keys (ownership routing never maps a shard to a dead rank)
        rows = np.empty(len(referenced), dtype=np.int64)
        for h in range(t.n_ranks):
            if h not in live:
                continue
            sel = owners == h
            got = host_codec.decode_row_ids(rep_in[h])
            rows[sel] = got

        # round 3 (gated): hotness bits for the adaptive ICI wire. Each
        # owner reads its LOCAL tier's decayed shows (shows_peek — pure,
        # never perturbs tier state) and replies one bit per requested key
        # in the requester's key order, packed 8 keys/byte. The round only
        # runs when the adaptive wire is engaged, so the ablation's host
        # exchange is byte-identical to the two-round historical one.
        from paddlebox_tpu_torch.ops import wire_quant as _wq  # lazy: import cycle

        if _wq.ici_adaptive_engaged():
            thr = float(config.get_flag("ici_hot_show"))
            owned_hot = (
                (table.shows_peek(owned) >= thr)
                if len(owned)
                else np.zeros(0, bool)
            )
            hot_out = []
            off = 0
            for h in range(t.n_ranks):
                k = req_keys[h]
                bits = (
                    owned_hot[pos_all[off : off + len(k)]]
                    if len(k)
                    else np.zeros(0, bool)
                )
                hot_out.append(np.packbits(bits.astype(np.uint8)).tobytes())
                off += len(k)
            STAT_ADD("wire.ws_hot_bytes", sum(len(b) for b in hot_out))
            t_x = time.perf_counter()
            hot_in = t.alltoall(hot_out, f"ws-hot:{self.pass_id}@e{self.epoch}")
            self.exchange_s += time.perf_counter() - t_x
            hot = np.zeros(self.n_mesh_shards * cap, dtype=bool)
            for h in range(t.n_ranks):
                if h not in live:
                    continue
                sel = owners == h
                nk = int(sel.sum())
                if nk:
                    bits = np.unpackbits(
                        np.frombuffer(hot_in[h], np.uint8), count=nk
                    ).astype(bool)
                    hot[rows[sel]] = bits
            self.hot_rows = hot

        self.sorted_keys = referenced  # np.unique output: sorted
        self.row_of_sorted = rows
        self._finalized = True
        self._table = table
        return dev

    def _finalize_spliced(self, table: HostSparseTable, carrier, cap: int):
        """Delta boundary over this host's carried shard block.

        Keys surviving from the previous pass splice out of the carried
        block on the card (decay applied there), the departing slice
        pushes to the LOCAL host table on a worker, and only the new keys
        pull host rows and cross the wire: the multi-host analog of
        PassWorkingSet._finalize_spliced, every step host-local by the
        stable key->shard->rank pinning. The device work is the port's two
        row kernels (``gather_rows`` in ``carrier.rows_for``,
        ``write_rows`` here). Returns ``[shards_per_host, cap, width]`` on
        the carrier's device."""
        import torch

        from paddlebox_tpu_torch.ops.pull_push import write_rows
        from paddlebox_tpu_torch.ops.wire_quant import send_rows
        from paddlebox_tpu_torch.utils.monitor import STAT_SET
        from paddlebox_tpu_torch.utils.trace import record_event

        W = table.layout.width
        spd = self.shards_per_host
        part = carrier.part
        if carrier.n_shards != spd:
            raise ValueError(
                f"a carrier of {carrier.n_shards} shards cannot splice into {spd}"
            )
        # this host's keys + block-local rows, shard by shard
        ks, rows = [], []
        for j in range(spd):
            k = self.owned_shard_keys[j]
            ks.append(k)
            rows.append(j * cap + np.arange(len(k), dtype=np.int64))
        new_keys = np.concatenate(ks) if ks else np.zeros(0, np.uint64)
        new_rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)

        old_keys = part.ws.sorted_keys
        if len(old_keys):
            pos_in_old = np.searchsorted(old_keys, new_keys)
            pos_in_old = np.minimum(pos_in_old, len(old_keys) - 1)
            common = old_keys[pos_in_old] == new_keys
        else:
            pos_in_old = np.zeros(len(new_keys), np.int64)
            common = np.zeros(len(new_keys), bool)
        common_old = pos_in_old[common]
        in_new = np.zeros(len(old_keys), dtype=bool)
        in_new[common_old] = True
        leave_pos = np.nonzero(~in_new)[0]
        if len(leave_pos):
            part.push_departures_async(table, old_keys[leave_pos], leave_pos)
        new_mask = ~common
        self.boundary_stats = {
            "common": int(common.sum()),
            "new": int(new_mask.sum()),
            "departed": len(leave_pos),
        }
        device = part.dev_flat.device

        def ids(mask):
            return torch.from_numpy(np.ascontiguousarray(new_rows[mask])).to(device)

        t0 = time.perf_counter()
        with record_event("boundary.splice", "boundary"):
            block = torch.zeros((spd * cap, W), dtype=torch.float32, device=device)
            if common.any():
                write_rows(block, ids(common), part.rows_for(common_old))
        STAT_SET("boundary.splice_s", time.perf_counter() - t0)
        if new_mask.any():
            t0 = time.perf_counter()
            with record_event("boundary.pull", "boundary"):
                host = table.pull_or_create(new_keys[new_mask])
            STAT_SET("boundary.pull_s", time.perf_counter() - t0)
            up = send_rows(host, table.layout, str(config.get_flag("wire_dtype")), device)
            write_rows(block, ids(new_mask), up)
        return block.reshape(spd, cap, W)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Batch keys -> GLOBAL row ids (int32); keys must be in the pass."""
        if len(self.sorted_keys) == 0:
            if len(keys):
                raise KeyError(
                    f"{len(keys)} batch keys but the pass working set is empty"
                )
            return np.zeros(0, np.int32)
        pos = np.searchsorted(self.sorted_keys, keys.astype(np.uint64))
        pos = np.minimum(pos, len(self.sorted_keys) - 1)
        if not np.all(self.sorted_keys[pos] == keys):
            missing = keys[self.sorted_keys[pos] != keys]
            raise KeyError(
                f"{len(missing)} batch keys not in pass working set (e.g. {missing[:5]})"
            )
        return self.row_of_sorted[pos].astype(np.int32)

    @property
    def padding_row(self) -> int:
        return self.capacity - 1

    @property
    def _finalized_ok(self) -> bool:
        return self._finalized

    def writeback(
        self,
        local_slice: np.ndarray,
        cancel: Optional[threading.Event] = None,
    ) -> None:
        """Flush THIS host's trained shard slice into its own host table —
        ownership == device placement, so nothing crosses hosts (EndPass
        parity, box_wrapper.cc:627). ``cancel`` (the overlapped-kick revert
        path) is checked between shard pushes: shards already pushed are
        covered by rollback's partial-writeback contract."""
        if self.owned_shard_keys is None or self.shards_per_host == 0:
            # a zero-width ownership range (uneven map, more ranks than
            # shards) trains nothing and owes the host table nothing
            return
        flat = np.asarray(local_slice).reshape(self.shards_per_host, self.capacity, -1)
        for s, keys in enumerate(self.owned_shard_keys):
            if cancel is not None and cancel.is_set():
                from paddlebox_tpu_torch.table.sparse_table import WritebackCancelled

                raise WritebackCancelled(
                    sum(len(k) for k in self.owned_shard_keys[:s]),
                    sum(len(k) for k in self.owned_shard_keys),
                )
            if len(keys):
                self._table.push(keys, flat[s, : len(keys)])


def hot_shard_loads(table, ownership: OwnershipMap, rank: int) -> np.ndarray:
    """Hotness-weighted per-mesh-shard load of ``rank``'s owned range
    (float64, length ``hi - lo``) — the elastic planner's load vector.

    The same Parallax-style frequency prior the adaptive ICI wire reads:
    each owned key weighs its decayed show count (``shows_peek`` — pure,
    mem-tier only) plus a residency term from the tiered store's
    occupancy split (``tier_stats`` per-host-shard mem/disk rows): a key
    whose host shard is mostly disk-resident is cheaper to move and
    colder to serve, so it weighs half a mem-resident key. Migrating or
    carving by this vector moves *hot* load, not raw key counts — a
    joiner carved at its quantile cuts takes traffic, not tombstone mass.
    Deterministic from the local table state; callers allgather the
    per-rank slices into the global vector."""
    lo, hi = ownership.range_of(int(rank))
    if hi <= lo:
        return np.zeros(0, dtype=np.float64)
    keys = table.keys()
    mesh = key_to_shard(keys, ownership.n_mesh_shards)
    mine = (mesh >= lo) & (mesh < hi)
    keys, mesh = keys[mine], mesh[mine]
    if len(keys) == 0:
        return np.zeros(hi - lo, dtype=np.float64)
    st = table.tier_stats()
    mem = np.asarray(st["per_shard"]["mem_rows"], dtype=np.float64)
    disk = np.asarray(st["per_shard"]["disk_rows"], dtype=np.float64)
    frac_mem = np.where(mem + disk > 0, mem / np.maximum(mem + disk, 1.0), 1.0)
    host = key_to_shard(keys, table.n_shards)
    residency = 0.5 + 0.5 * frac_mem[host]
    w = residency + np.asarray(table.shows_peek(keys), dtype=np.float64)
    return np.bincount(mesh - lo, weights=w, minlength=hi - lo).astype(
        np.float64
    )
