"""Online AUC — bucketed calculator, device-resident.

Port of the JAX package's ``metrics/auc.py`` (BasicAucCalculator parity,
box_wrapper.h:61-138): predictions hash into ``n_buckets`` pos/neg count
tables; AUC plus bucket_error, MAE, RMSE, actual/predicted CTR derive from
the tables.

The state is two int32 bucket tables updated by one scatter-add on the
device (no host sync per step; integer adds give the same table whatever
order they land in). Every derived statistic integrates over the bucket
tables in f64 on the host.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, NamedTuple, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from paddlebox_tpu_torch.parallel.mesh import MeshPlan


class AucState(NamedTuple):
    pos: torch.Tensor  # int32 [n_buckets] click counts per prediction bucket
    neg: torch.Tensor  # int32 [n_buckets] non-click counts


AUC_BUCKET_CAP = np.int32(1 << 30)  # saturation ceiling (overflow guard)


def auc_init(n_buckets: int = 1_000_000, device: torch.device | str = "cuda") -> AucState:
    return AucState(
        pos=torch.zeros((n_buckets,), dtype=torch.int32, device=device),
        neg=torch.zeros((n_buckets,), dtype=torch.int32, device=device),
    )


def auc_update(
    state: AucState,
    preds: torch.Tensor,  # f32 [B] in [0, 1]
    labels: torch.Tensor,  # f32 [B] 0/1
    mask: Optional[torch.Tensor] = None,  # [B] 1 = count this sample
) -> AucState:
    """Accumulate one batch (add_data/cuda_add_data parity)."""
    n_buckets = state.pos.shape[0]
    if mask is None:
        imask = torch.ones(preds.shape, dtype=torch.int32, device=preds.device)
    else:
        imask = mask.to(torch.int32)
    bucket = torch.clamp((preds * n_buckets).to(torch.int32), 0, n_buckets - 1)
    ilab = (labels > 0.5).to(torch.int32)
    # ONE scatter over [pos ++ neg]: a click adds at bucket, a non-click at
    # n_buckets + bucket
    tab = torch.cat([state.pos, state.neg])
    tab = tab.index_add(0, (bucket + (1 - ilab) * n_buckets).long(), imask)
    # saturate at 2^30: a bucket that hot stops counting instead of
    # wrapping int32; auc_compute reports `saturated`
    tab = torch.clamp(tab, max=int(AUC_BUCKET_CAP))
    return AucState(pos=tab[:n_buckets], neg=tab[n_buckets:])


def auc_psum(state: AucState, plan: "MeshPlan") -> AucState:
    """The bucket tables summed over the mesh (collect_data_nccl parity):
    one ``all_reduce`` of the int32 tables, exact in any order."""
    both = plan.all_reduce(torch.cat([state.pos, state.neg]))
    n = state.pos.shape[0]
    return AucState(pos=both[:n], neg=both[n:])


def auc_compute(state: AucState) -> Dict[str, float]:
    """Host-side f64 integration (BasicAucCalculator::compute parity)."""
    pos = state.pos.cpu().numpy().astype(np.float64)
    neg = state.neg.cpu().numpy().astype(np.float64)
    saturated = float(
        np.any(pos >= float(AUC_BUCKET_CAP)) or np.any(neg >= float(AUC_BUCKET_CAP))
    )
    n_buckets = len(pos)
    center = (np.arange(n_buckets, dtype=np.float64) + 0.5) / n_buckets

    # AUC = P(score_pos > score_neg): for each negative bucket, count
    # positives in strictly higher buckets + half of same-bucket ties
    tot_pos = np.cumsum(pos)
    p, n = tot_pos[-1], np.sum(neg)
    pos_above = p - tot_pos
    area = np.sum(neg * (pos_above + pos / 2.0))
    auc = float(area / (p * n)) if p > 0 and n > 0 else 0.5

    # bucket error: impression-weighted |predicted - actual| ctr over
    # buckets with enough traffic
    show = pos + neg
    keep = show > 8
    if keep.any():
        rel = np.abs(center[keep] - pos[keep] / show[keep])
        bucket_error = float(np.sum(rel * show[keep]) / np.sum(show[keep]))
    else:
        bucket_error = 0.0

    count = float(p + n)
    safe = max(count, 1.0)
    pred_sum = float(np.sum(center * show))
    # label 1 -> |pred-label| = 1-pred ; label 0 -> pred
    abserr = float(np.sum(pos * (1.0 - center) + neg * center))
    sqrerr = float(np.sum(pos * (1.0 - center) ** 2 + neg * center**2))
    return {
        "auc": auc,
        "bucket_error": bucket_error,
        "mae": abserr / safe,
        "rmse": float(np.sqrt(sqrerr / safe)),
        "actual_ctr": float(p) / safe,
        "predicted_ctr": pred_sum / safe,
        "copc": float(p) / max(pred_sum, 1e-12),
        "ins_num": count,
        "saturated": saturated,
    }
