"""CTR-specific dense ops: rank_attention, batch_fc, fused_concat.

Port of the JAX package's ``ops/ctr_ops.py``. ``batch_fc`` (a per-channel
FC, the reference's batch_fc_op.cu) is one batched matrix product and
``fused_concat`` (fused_concat_op.cu) a column slice and concatenation;
the JAX package leaves both to XLA, and they are plain PyTorch here.

``rank_attention`` (position-aware attention over pv-merged ad lists; the
reference's operators/rank_attention_op.cu): the JAX package leaves it to XLA as a
gather and an einsum; here it is a ``torch.autograd.Function`` whose
backward has a fixed reduction order, so a join step gives the same bits
on every run on the card:

- forward: the peers' inputs gathered into ``x_exp`` [B, R, F] (zero where
  the pair is invalid), one matmul by the parameter laid out as [F, R*R*C]
  (every pair block at once), then each (instance, peer)'s own pair column
  picked out, masked and summed over the peers. The [B, R, F, C] blocks of
  the einsum are never built.
- backward: the gradient of ``x_exp`` is a matmul of the one-hot-by-pair
  output gradient with the parameter; it reaches ``x`` through the port's
  fixed-order ``segment_sum`` over the peer rows (invalid peers go to a
  dump segment), never through an accumulating scatter. The parameter's
  gradient is ``x_exp^T`` times the one-hot-by-pair output gradient, a
  matmul: a pair block no instance uses gets exactly zero.
"""

from __future__ import annotations

from typing import Sequence

import torch

from paddlebox_tpu_torch.ops.seqpool_cvm import segment_sum


def _expand(rank_offset: torch.Tensor, B: int, R: int):
    """(peer rows [B, R] clipped into the batch, pair index [B, R] = own *
    R + peer rank, clipped, valid [B, R]). Invalid entries are -1 in
    ``rank_offset`` (``build_rank_offset``): an instance without a valid
    own rank, or a peer slot with no ad."""
    own = rank_offset[:, 0] - 1
    peer_rank = rank_offset[:, 1::2] - 1
    peer_idx = rank_offset[:, 2::2]
    valid = (own[:, None] >= 0) & (peer_rank >= 0)
    pair = torch.clamp(own, 0, R - 1)[:, None] * R + torch.clamp(peer_rank, 0, R - 1)
    return torch.clamp(peer_idx, 0, B - 1).long(), pair.long(), valid


def _one_hot_grad(grad_out: torch.Tensor, pair: torch.Tensor, valid: torch.Tensor, R: int):
    """[B*R, R*R*C]: the output gradient of each valid (instance, peer)
    placed in its pair's C columns, zero elsewhere."""
    B, C = grad_out.shape
    hit = (pair[..., None] == torch.arange(R * R, device=pair.device)) & valid[..., None]  # [B, R, R*R]
    g = torch.where(hit[..., None], grad_out[:, None, None, :], 0.0)  # [B, R, R*R, C]
    return g.reshape(B * R, R * R * C)


class _RankAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank_offset, rank_param, max_rank):
        B, F = x.shape
        R = max_rank
        C = rank_param.shape[-1]
        peer, pair, valid = _expand(rank_offset, B, R)
        x_exp = torch.where(
            valid[..., None], x.index_select(0, peer.reshape(-1)).reshape(B, R, F), 0.0
        )  # [B, R, F]
        # [R(own), R(peer), F, C] -> [F, R*R*C]: column (o*R + p)*C + c
        P = rank_param.reshape(R, R, F, C).permute(2, 0, 1, 3).reshape(F, R * R * C)
        y = (x_exp.reshape(B * R, F) @ P).reshape(B, R, R * R, C)
        picked = torch.gather(y, 2, pair[..., None, None].expand(B, R, 1, C))[:, :, 0, :]
        out = torch.where(valid[..., None], picked, 0.0).sum(dim=1)  # [B, C]
        ctx.save_for_backward(x_exp, P, peer, pair, valid)
        ctx.dims = (B, F, R, C)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x_exp, P, peer, pair, valid = ctx.saved_tensors
        B, F, R, C = ctx.dims
        gy = _one_hot_grad(grad_out.contiguous(), pair, valid, R)  # [B*R, R*R*C]
        grad_x = grad_param = None
        if ctx.needs_input_grad[0]:
            g_exp = gy @ P.t()  # [B*R, F]; zero rows where invalid
            ids = torch.where(valid, peer, B).reshape(-1)  # invalid -> the dump segment B
            grad_x = segment_sum(g_exp, ids, B + 1)[:B]
        if ctx.needs_input_grad[2]:
            gP = x_exp.reshape(B * R, F).t() @ gy  # [F, R*R*C]
            grad_param = gP.reshape(F, R, R, C).permute(1, 2, 0, 3).reshape(R * R * F, C)
        return grad_x, None, grad_param, None


def rank_attention(
    x: torch.Tensor,  # [B, F] per-ad input features
    rank_offset: torch.Tensor,  # int32 [B, 2*max_rank+1]
    rank_param: torch.Tensor,  # [max_rank*max_rank*F, C] position-pair blocks
    max_rank: int = 3,
) -> torch.Tensor:
    """Position-pair attention over pv-grouped ads -> [B, C].

    Semantics (rank_attention.cu.h:27-112 expand kernels):

    - ``rank_offset[i, 0]``    = 1-based rank of ad i in its pv (-1 = none)
    - ``rank_offset[i, 2k+1]`` = 1-based rank of the k-th peer ad (-1 = absent)
    - ``rank_offset[i, 2k+2]`` = row of that peer in ``x``
    - ``rank_param`` reshaped [max_rank(own), max_rank(peer), F, C]: a
      weight block per (own rank, peer rank) pair.

        out[i] = sum_k  x[peer_k(i)] @ rank_param[own(i), peer_rank_k(i)]

    Absent peers and rankless instances contribute zero.
    """
    return _RankAttention.apply(x, rank_offset, rank_param, max_rank)


def batch_fc(
    x: torch.Tensor,  # [B, batchcount * in_feat]
    w: torch.Tensor,  # [in_feat, batchcount * out_feat]
    bias: torch.Tensor,  # [batchcount * out_feat]
    batchcount: int,
) -> torch.Tensor:
    """Per-channel FC -> [B, batchcount * out_feat]: channel k maps
    ``x[:, k*in : (k+1)*in]`` through ``w[:, k*out : (k+1)*out]`` plus its
    bias (the reference's strided BatchedGEMM and row add,
    batch_fc_op.cu:121-188), every channel in one batched matmul."""
    B = x.shape[0]
    in_feat = x.shape[1] // batchcount
    out_feat = w.shape[1] // batchcount
    xb = x.reshape(B, batchcount, in_feat).transpose(0, 1)  # [k, B, in]
    wb = w.reshape(in_feat, batchcount, out_feat).transpose(0, 1)  # [k, in, out]
    out = torch.bmm(xb, wb).transpose(0, 1)  # [B, k, out]
    return (out + bias.reshape(1, batchcount, out_feat)).reshape(B, -1)


def fused_concat(xs: Sequence[torch.Tensor], offset: int, length: int) -> torch.Tensor:
    """Columns [offset, offset + length) of every [B, D] input, side by
    side -> [B, n * length] (fused_concat_op.cu:207-260): typically the
    embedx block of several pulled slot tensors in one op."""
    return torch.cat([x[:, offset : offset + length] for x in xs], dim=1)
