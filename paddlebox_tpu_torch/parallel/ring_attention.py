"""Sequence parallelism: ring attention and Ulysses attention over the
process group.

Port of the JAX package's ``parallel/ring_attention.py``. The sequence
axis is sharded over a 1-D :class:`~paddlebox_tpu_torch.parallel.mesh.MeshPlan`:
rank ``i`` holds global positions ``[i * S_local, (i + 1) * S_local)`` of
q, k and v, each ``[B, S_local, H, D]``. Both schemes are exact, not
approximations:

- :func:`ring_attention`: q stays put while the (k, v) blocks rotate
  around the ring by :meth:`MeshPlan.shift` (the cyclic ``ppermute``), k
  and v stacked into one shift a step; a running log-sum-exp accumulator
  merges each block. The forward makes ``n - 1`` shifts: the JAX scan's
  last ``ppermute`` carries a block that no step reads, and is dropped.
- :func:`ulysses_attention`: one tiled all_to_all
  (:meth:`MeshPlan.tiled_all_to_all`, q, k and v stacked) turns
  ``[seq-sharded, all heads]`` into ``[full seq, H / n heads]``, exact
  local attention streams the keys in chunks, and a second all_to_all
  swaps back.

Both are differentiable: the shift's and the all_to_all's backward is the
inverse collective, so every rank must call them alike, forward and
backward. A ring's forward and backward make ``2 (n - 1)`` shifts on
every rank, a Ulysses call's 4 all_to_alls.

The block math is the JAX module's, in plain tensor ops (no packaged
attention): scores in fp32 (bf16 q and k are cast first: the product of
two bf16 values is exact in fp32, as the JAX einsum's
``preferred_element_type`` computes), the finite ``-1e30`` mask over
global positions, the online max / exp / sum merge and the ``1e-30``
guard on the normaliser. ``remat`` checkpoints each step's block math
(``torch.utils.checkpoint``), never a collective: the backward replays the
scores and probabilities, and no ``[Sq, Sk]`` block is kept for it.

The functions take the tensors on ``plan.device`` and nothing else:
the plan's device decides where they run. The module has no parameters,
so ``models/convert.py`` carries nothing for it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from paddlebox_tpu_torch.parallel.mesh import MeshPlan

_NEG_INF = -1e30  # finite "-inf": exp() gives 0 without a NaN max or subtraction
_GUARD = 1e-30  # the normaliser's floor: only a row with no allowed key is 0
KV_CHUNK = 512  # _flash_local's target key chunk


def _block_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B, Sq, H, D], k [B, Sk, H, D] -> [B, H, Sq, Sk] in fp32."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).mul_(scale)


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """[Sq, Sk]: True where the key's position is at most the query's."""
    return q_pos[:, None] >= k_pos[None, :]


def _merge_block(
    q: torch.Tensor,
    kt: torch.Tensor,
    vt: torch.Tensor,
    o: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    scale: float,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One key block into the running accumulators: o [B, H, Sq, D], the
    running max m and sum l [B, H, Sq], all fp32."""
    s = _block_scores(q, kt, scale)
    if causal:
        allowed = _causal_mask(q_pos, k_pos)
        s = s.masked_fill_(~allowed, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # renormalise the earlier accumulators to the new running max
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if causal:  # exp(NEG_INF - m) underflows to 0 already; kept exact
        p = p.masked_fill(~allowed, 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vt.float())
    return o_new, m_new, l_new


def _accumulators(B: int, H: int, S: int, D: int, device: torch.device):
    o = torch.zeros((B, H, S, D), dtype=torch.float32, device=device)
    m = torch.full((B, H, S), _NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=device)
    return o, m, l


def _merge(remat: bool, *args):
    """:func:`_merge_block`, checkpointed under ``remat`` when autograd
    records (a forward under ``no_grad`` keeps nothing to replay)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(_merge_block, *args, use_reentrant=False)
    return _merge_block(*args)


def _finish(o: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The normalised output, [B, H, S, D] -> [B, S, H, D] fp32."""
    return (o / torch.clamp(l, min=_GUARD)[..., None]).permute(0, 2, 1, 3)


def _axis_plan(plan: MeshPlan, axis_name: Optional[str], *xs: torch.Tensor) -> MeshPlan:
    """The 1-D plan of ``axis_name`` (the plan's own axis by default),
    after checking that every tensor sits on its device."""
    sub = plan.along(axis_name if axis_name is not None else plan.axis)
    for x in xs:
        if x.device != sub.device:
            raise ValueError(f"a tensor on {x.device}: the plan's device is {sub.device}")
    return sub


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    plan: MeshPlan,
    axis_name: Optional[str] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    remat: bool = True,
) -> torch.Tensor:
    """Exact attention over the whole sharded sequence: this rank's
    ``[B, S_local, H, D]`` block of it, in q's dtype.

    With ``causal`` the mask applies to global positions, so a block from
    a later rank adds exactly nothing. ``remat`` replays each step's block
    math in the backward; what it keeps is each step's incoming (k, v),
    O(S_global * D) a rank, with no ``[S_local, S_global]`` term."""
    sp = _axis_plan(plan, axis_name, q, k, v)
    n, idx = sp.world, sp.rank
    B, S, H, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    q_pos = idx * S + torch.arange(S, device=q.device)
    o, m, l = _accumulators(B, H, S, D, q.device)
    kv = torch.stack([k, v])
    for t in range(n):
        if t:
            kv = sp.shift(kv)
        # the block held at step t came from rank (idx - t) mod n
        k_pos = ((idx - t) % n) * S + torch.arange(S, device=q.device)
        o, m, l = _merge(remat, q, kv[0], kv[1], o, m, l, q_pos, k_pos, scale, causal)
    return _finish(o, l).to(q.dtype)


def _chunk_size(sk: int, kv_chunk: int = KV_CHUNK) -> int:
    """The largest divisor of ``sk`` that is at most ``kv_chunk``."""
    chunk = min(kv_chunk, sk)
    while sk % chunk:
        chunk -= 1
    return chunk


def _flash_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    causal: bool,
    kv_chunk: int = KV_CHUNK,
    remat: bool = True,
) -> torch.Tensor:
    """Exact attention on one device with the keys streamed in chunks
    (the online softmax): q [B, Sq, H, D], k / v [B, Sk, H, D] ->
    [B, Sq, H, D] fp32. q and k share the origin, so the causal mask is
    the unchunked one. ``remat`` keeps no ``[B, H, Sq, chunk]`` block for
    the backward."""
    B, Sq, H, D = q.shape
    sk = k.shape[1]
    chunk = _chunk_size(sk, kv_chunk)
    q_pos = torch.arange(Sq, device=q.device)
    o, m, l = _accumulators(B, H, Sq, D, q.device)
    for t in range(sk // chunk):
        lo = t * chunk
        k_pos = lo + torch.arange(chunk, device=q.device)
        o, m, l = _merge(remat, q, k[:, lo : lo + chunk], v[:, lo : lo + chunk], o, m, l, q_pos, k_pos, scale,
                         causal)
    return _finish(o, l)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    plan: MeshPlan,
    axis_name: Optional[str] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    remat: bool = True,
) -> torch.Tensor:
    """DeepSpeed-Ulysses: all_to_all to ``[full seq, H / n heads]``, exact
    chunked attention, all_to_all back. ``[B, S_local, H, D]`` in q's
    dtype; needs ``H % n == 0``."""
    sp = _axis_plan(plan, axis_name, q, k, v)
    n = sp.world
    H, D = q.shape[2:]
    if H % n != 0:
        raise ValueError(f"n_heads {H} not divisible by axis size {n}")
    scale = scale if scale is not None else D ** -0.5
    # [3, B, S, H, D] -> [3, B, S * n, H / n, D]: heads split, sequence gathered
    qf, kf, vf = sp.tiled_all_to_all(torch.stack([q, k, v]), split_dim=3, concat_dim=2)
    of = _flash_local(qf, kf, vf, scale, causal, remat=remat)
    return sp.tiled_all_to_all(of.to(q.dtype), split_dim=1, concat_dim=2)
