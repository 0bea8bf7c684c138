"""Sharded-table pull/push: fixed-shape ``all_to_all`` over the mesh.

Port of the JAX package's ``parallel/sharded_pullpush.py`` (the
reference's multi-node sparse path, PullSparseGPU/PushSparseGPU with key
routing inside the library, box_wrapper_impl.h:122, :229). Every rank runs
these on its own shard ``table_local`` [cap, width]:

pull:
  1. the host packer bucketed this rank's unique rows by owner shard into
     ``req_ranks`` [n, K] (the row within the shard; pads name the padding
     row ``cap - 1``, and slot K-1 of every bucket is a pad);
  2. ``all_to_all`` routes the request buckets to their owners;
  3. each owner gathers its rows (``pull_sparse_rows``: the row gather
     kernel ``pull_rows_cuda`` on a card);
  4. ``all_to_all`` routes the value buckets back, so the batch's
     ``inverse`` (bucket positions ``s*K + j``) addresses them directly.

push reverses the route: per-bucket merged gradients with their show/clk
counts travel to the owner, which merges the records of each row (a stable
sort by row, then a segment sum), applies the sparse optimizer once a row
and writes the rows back (:func:`_owner_merge_push`): the same update
however many ranks touched the row.

The value payloads ride the ``ici_wire_dtype`` format
(``ops/wire_quant.py``): bf16, int8 with one max-abs scale a record and
section, or the adaptive split (bucket slots before ``ici_hot_slots(K)``
bf16, after it int8). The head columns (the pull's counters, the push's
show/clk) stay fp32. Each call sets ``wire.a2a_payload_bytes``,
``wire.a2a_fp32_bytes``, ``wire.a2a_hot_slots`` and
``wire.a2a_dtype_bits``. The casts round half to even and the int8 scale
is ``max|v| * fl(1/127)`` (what XLA makes of JAX's division by 127), so
the payload is the JAX package's bit for bit.

The owner's writeback: JAX adds ``(new - old) * valid`` at every run's
rank, where the runs past the number of distinct rows all name row 0 with
zero deltas. ``write_rows_cuda`` needs repeated ids to carry identical
bytes, so the port writes ``old + (new - old)`` (JAX's fp32 ops) for the
valid runs and names every other run ``R`` (the shard's row count), which
writes nothing. On the CPU those ids are dropped before the plain
writeback (``cuda_kernels.drop_out_of_range``), which takes ids in range
only.

:func:`sharded_serve_pull` is the device scoring tier's pull: one process
holds every shard, shard ``s`` on its own device, and no process group
runs (the JAX package's tier is one process over a mesh of local devices).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from paddlebox_tpu_torch.ops import wire_quant as wq
from paddlebox_tpu_torch.ops.cuda_kernels import drop_out_of_range
from paddlebox_tpu_torch.ops.pull_push import (
    gather_rows,
    pull_sparse_rows,
    pull_sparse_rows_extended,
    sparse_update_rows,
    write_rows,
)
from paddlebox_tpu_torch.ops.seqpool_cvm import segment_sum
from paddlebox_tpu_torch.parallel.mesh import MeshPlan
from paddlebox_tpu_torch.table.optimizers import SparseOptimizerConfig
from paddlebox_tpu_torch.table.value_layout import ValueLayout
from paddlebox_tpu_torch.utils.monitor import STAT_SET


def _bf16_vals_a2a(plan: MeshPlan, vals: torch.Tensor) -> torch.Tensor:
    """Value columns at half width: bf16 on the wire, fp32 out."""
    return plan.all_to_all(vals.to(torch.bfloat16)).float()


def _int8_vals_a2a(plan: MeshPlan, recs: torch.Tensor, sections: List[Tuple[int, int]]) -> torch.Tensor:
    """The value sections of [n, k, W] records as int8 with one scale a
    record and section; returns the fp32 value columns [n, k, sum(widths)].
    Two collectives whatever the section count: the int8 payload and the
    stacked scales."""
    qs, scales = [], []
    # the scale is max|v| times fl(1/127): XLA compiles the JAX package's
    # division by the constant 127 (inside its jitted step) so
    inv127 = torch.full((), 1.0 / 127.0, dtype=recs.dtype, device=recs.device)
    for a, b in sections:
        v = recs[:, :, a:b]
        s = torch.clamp_min(v.abs().amax(dim=2), 1e-12) * inv127
        q = torch.clamp(torch.round(v / s[..., None]), -127.0, 127.0)
        qs.append(torch.nan_to_num(q, nan=0.0).to(torch.int8))
        scales.append(s)
    qr = plan.all_to_all(torch.cat(qs, dim=2))
    sr = plan.all_to_all(torch.stack(scales, dim=2))  # [n, k, n_sections]
    outs, off = [], 0
    for si, (a, b) in enumerate(sections):
        w = b - a
        outs.append(qr[:, :, off : off + w].float() * sr[:, :, si : si + 1])
        off += w
    return torch.cat(outs, dim=2)


def _compressed_a2a(plan: MeshPlan, recs: torch.Tensor, head: int, sections: List[Tuple[int, int]]) -> torch.Tensor:
    """``all_to_all`` of [n, K, W] records under the ``ici_wire_dtype`` flag.

    ``head`` columns always ride fp32; each ``(a, b)`` of ``sections`` is a
    value family with its own int8 scale. ``adaptive`` sends each bucket's
    first H = ``ici_hot_slots(K)`` slots bf16 and the rest int8 (the packer
    put hot rows first); slicing K commutes with the exchange over dim 0,
    so the halves reassemble by concatenation. H = 0 and H = K run the
    uniform int8 and bf16 wires exactly."""
    mode = wq.ici_effective_mode()
    n, K, W = int(recs.shape[0]), int(recs.shape[1]), int(recs.shape[2])
    hot = wq.ici_hot_slots(K) if mode == "adaptive" else 0
    payload = wq.ici_wire_nbytes(n, K, W, head, len(sections), mode, hot)
    STAT_SET("wire.a2a_payload_bytes", payload)
    STAT_SET("wire.a2a_fp32_bytes", n * K * W * 4)
    STAT_SET("wire.a2a_hot_slots", hot)
    if mode == "adaptive":
        bits = int(round(payload * 8 / (n * K * W)))
        mode = "int8" if hot <= 0 else "bf16" if hot >= K else mode
    else:
        bits = {"fp32": 32, "bf16": 16, "int8": 8}[mode]
    STAT_SET("wire.a2a_dtype_bits", bits)
    if mode == "fp32":
        return plan.all_to_all(recs)
    counts = plan.all_to_all(recs[:, :, :head])
    if mode == "bf16":
        vals = _bf16_vals_a2a(plan, recs[:, :, head:])
    elif mode == "int8":
        vals = _int8_vals_a2a(plan, recs, sections)
    else:
        hot_vals = _bf16_vals_a2a(plan, recs[:, :hot, head:])
        cold_vals = _int8_vals_a2a(plan, recs[:, hot:, :], sections)
        vals = torch.cat([hot_vals, cold_vals], dim=1)
    return torch.cat([counts, vals], dim=2)


def sharded_pull(
    plan: MeshPlan,
    table_local: torch.Tensor,  # [cap, width] this rank's shard
    req_ranks: torch.Tensor,  # int32 [n_shards, K] this rank's requests
    layout: ValueLayout,
    embedx_threshold: float,
    scale: float = 1.0,
    extended: bool = False,
) -> torch.Tensor:
    """Pull records for this rank's request buckets: [n_shards*K, pull_w]
    (with ``extended``, the expand block as trailing columns). Row
    ``s*K + j`` answers request slot j of shard s."""
    n, K = req_ranks.shape
    req_recv = plan.all_to_all(req_ranks)  # row d = the bucket rank d asks of this shard
    if extended:
        rec, exp = pull_sparse_rows_extended(
            table_local, req_recv.reshape(-1), layout, embedx_threshold, scale
        )
        resp = torch.cat([rec, exp], dim=1).reshape(n, K, -1)
    else:
        resp = pull_sparse_rows(
            table_local, req_recv.reshape(-1), layout, embedx_threshold, scale
        ).reshape(n, K, -1)
    a = layout.embed_w_col  # the first value column of a record
    W, pull_w = resp.shape[2], layout.pull_width
    sections = [(a, pull_w), (pull_w, W)] if extended else [(a, W)]
    return _compressed_a2a(plan, resp, a, sections).reshape(n * K, -1)


def sharded_push(
    plan: MeshPlan,
    table_local: torch.Tensor,  # [cap, width], updated in place
    req_ranks: torch.Tensor,  # int32 [n_shards, K]
    grads_bucket: torch.Tensor,  # [n_shards*K, gw] merged grads by bucket position
    show_bucket: torch.Tensor,  # f32 [n_shards*K]
    clk_bucket: torch.Tensor,  # f32 [n_shards*K]
    layout: ValueLayout,
    opt: SparseOptimizerConfig,
) -> torch.Tensor:
    """Route the push records to their owners, merge them a row, apply the
    optimizer once a row; updates ``table_local`` in place and returns it.
    The owner's work scales with the batch's requests, never with the
    shard's capacity."""
    n, K = req_ranks.shape
    gw = grads_bucket.shape[1]  # pull_width, or + expand_dim (extended)
    recs = torch.cat([show_bucket[:, None], clk_bucket[:, None], grads_bucket], dim=1).reshape(n, K, gw + 2)
    # the show/clk counts stay fp32 (bf16 is exact only to 256); an
    # extended push's expand grads quantize as their own section
    pw2 = 2 + layout.push_width
    sections = [(2, pw2), (pw2, gw + 2)] if gw > layout.push_width else [(2, gw + 2)]
    recs_recv = _compressed_a2a(plan, recs, 2, sections)
    ranks_recv = plan.all_to_all(req_ranks)
    M = n * K
    return _owner_merge_push(table_local, ranks_recv.reshape(M), recs_recv.reshape(M, gw + 2), layout, opt)


def _owner_merge_push(
    table_local: torch.Tensor,
    flat_ranks: torch.Tensor,  # int32 [M] the received rows, rank-major
    flat_recs: torch.Tensor,  # [M, 2 + gw] [show, clk, grads]
    layout: ValueLayout,
    opt: SparseOptimizerConfig,
) -> torch.Tensor:
    """The owner's merge and apply of M received push records, in place.

    A stable sort by row groups the duplicates into runs; each run's
    records sum (a segment sum in sorted order); the old rows are gathered
    (``gather_rows``: the row gather kernel on a card), updated and
    written back (``write_rows``: the writeback kernel), the runs past
    the last distinct row named out of range. No host sync."""
    M = flat_ranks.shape[0]
    R = table_local.shape[0]
    dev = flat_ranks.device
    sr, order = torch.sort(flat_ranks, stable=True)
    srecs = flat_recs.index_select(0, order)
    is_head = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), sr[1:] != sr[:-1]])
    seg = torch.cumsum(is_head.to(torch.int32), dim=0, dtype=torch.int32) - 1  # run id
    n_uniq = seg[-1] + 1
    merged = segment_sum(srecs, seg, M)  # runs >= n_uniq are zero
    # one row a run: the duplicates of a run name the same row
    rep_rank = torch.zeros((M,), dtype=sr.dtype, device=dev).scatter_(0, seg.long(), sr)
    old = gather_rows(table_local, rep_rank)
    new = sparse_update_rows(old, merged[:, 2:], merged[:, 0], merged[:, 1], layout, opt)
    valid = torch.arange(M, dtype=torch.int32, device=dev) < n_uniq
    ids, vals = torch.where(valid, rep_rank.to(torch.int64), R), old + (new - old)
    if not table_local.is_cuda:  # the plain writeback takes ids in [0, R) only
        ids, vals = drop_out_of_range(table_local, ids, vals)
    return write_rows(table_local, ids, vals)


def sharded_serve_pull(tables: List[torch.Tensor], req_ranks: torch.Tensor) -> torch.Tensor:
    """The device scoring tier's pull: ``tables[s]`` is shard ``s`` [cap,
    width] on its device, ``req_ranks`` [n, n, K] the request buckets of
    ``route_serve_requests`` (requester d, owner s). Returns the rows on
    the host, [n, n*K, width] in the JAX package's order: row ``s*K + j``
    of requester d answers its slot j at shard s.

    Each owner gathers every requester's slots of its shard in one
    ``gather_rows`` on its device (``pull_rows_cuda`` on a card), which
    is what the JAX owner gathers after the request ``all_to_all``. The
    rows come back verbatim, fp32: no embedx gating, no CVM scale, no
    wire, so a tier hit is bitwise the committed version's row."""
    n, _, K = req_ranks.shape
    width = tables[0].shape[1]
    out = torch.empty((n, n, K, width), dtype=torch.float32)
    for s, tab in enumerate(tables):
        ids = req_ranks[:, s, :].reshape(-1).to(tab.device)
        out[:, s] = gather_rows(tab, ids).reshape(n, K, width).cpu()
    return out.reshape(n, n * K, width)
