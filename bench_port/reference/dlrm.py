"""DLRM-DCNv2 (MLPerf Training's recommendation model), plain float32,
and the plain reference of its multi-hot training step.

Sources: the MLCommons reference (``recommendation_v2/torchrec_dlrm``),
DCN-V2 (Wang et al., WWW 2021, arXiv:2008.13535, eq. 1 with the low-rank
``W = U V^T`` of its section 5) and DLRM (Naumov et al., arXiv:1906.00091).
Input: the CVM'd pooled slot records [B, S, 3 + D] and the dense features
[B, 13]:

- each slot's embedding is its last D columns (the table's show, clk and
  embed_w stay in the port's layout and are not read);
- bottom: ReLU after every layer, 13 -> 512-256-128;
- ``x0 = [bottom output; the S embeddings]``, then each cross layer
  ``x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l``, V_l with no bias;
- top: ReLU after every layer, 1024-1024-512-256, then a linear head.

Every product of the tower, the cross's included, goes through the
``linear`` hook (the fp8 control reaches all of them); the head is fp32,
as the port's. No dropout.

The multi-hot step (:class:`MultiHotTrainer`) is ``common``'s step with
the pooling put in: each record gated, summed per (sample, slot) in key
order, then CVM -> model -> mean BCE; each record's gradient is its
pooled feature's, and ``common``'s merge by key, sparse AdaGrad and Adam
take it from there. A batch's ``keys`` are [B, K] uint64, columns in slot
order, ``cfg["multi_hot_sizes"][s]`` columns a slot; a 0 is no key. The
records are gathered a column at a time, so no [B, K, W] tensor is made
in the forward.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.common import SHOW, ReferenceTrainer, auc_buckets, cvm, fp32_linear

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _n(params: Dict[str, torch.Tensor], prefix: str) -> int:
    return sum(1 for k in params if k.startswith(prefix) and k.endswith(".weight"))


def param_shapes(cfg: dict) -> List[Tuple[str, tuple]]:
    """The dense params' names and shapes, in the order weights are drawn."""
    d = (cfg["num_slots"] + 1) * cfg["embedx_dim"]
    r = cfg["cross_rank"]
    out = []
    bottom = [cfg["dense_dim"], *cfg["bottom_mlp"]]
    for i in range(len(bottom) - 1):
        out += [(f"bottom.{i}.weight", (bottom[i + 1], bottom[i])), (f"bottom.{i}.bias", (bottom[i + 1],))]
    for l in range(cfg["cross_layers"]):
        out += [(f"cross.{l}.V.weight", (r, d)), (f"cross.{l}.W.weight", (d, r)), (f"cross.{l}.W.bias", (d,))]
    top = [d, *cfg["top_mlp"]]
    for i in range(len(top) - 1):
        out += [(f"top.{i}.weight", (top[i + 1], top[i])), (f"top.{i}.bias", (top[i + 1],))]
    out += [("out.weight", (1, top[-1])), ("out.bias", (1,))]
    return out


def _relu_mlp(params, prefix: str, h: torch.Tensor, linear: Callable) -> torch.Tensor:
    for i in range(_n(params, prefix)):
        h = torch.relu(linear(h, params[f"{prefix}{i}.weight"], params[f"{prefix}{i}.bias"]))
    return h


def forward(params: Dict[str, torch.Tensor], feats: torch.Tensor, dense, linear=fp32_linear) -> torch.Tensor:
    B = feats.shape[0]
    d = _relu_mlp(params, "bottom.", dense, linear)
    x0 = torch.cat([d, feats[:, :, -d.shape[1] :].reshape(B, -1)], dim=1)
    x = x0
    for l in range(_n(params, "cross.") // 2):
        v = params[f"cross.{l}.V.weight"]
        u = linear(x, v, torch.zeros(v.shape[0], dtype=x.dtype, device=x.device))
        x = x0 * linear(u, params[f"cross.{l}.W.weight"], params[f"cross.{l}.W.bias"]) + x
    h = _relu_mlp(params, "top.", x, linear)
    return fp32_linear(h, params["out.weight"], params["out.bias"])[:, 0]


def tower_flops_per_sample(cfg: dict) -> int:
    """Forward and backward FLOPs of the bottom, the cross layers, the top
    and the head a sample (6 a weight)."""
    d = (cfg["num_slots"] + 1) * cfg["embedx_dim"]
    bottom = [cfg["dense_dim"], *cfg["bottom_mlp"]]
    top = [d, *cfg["top_mlp"], 1]
    macs = sum(a * b for a, b in zip(bottom, bottom[1:])) + sum(a * b for a, b in zip(top, top[1:]))
    return 6 * (macs + cfg["cross_layers"] * 2 * d * cfg["cross_rank"])


class MultiHotTrainer(ReferenceTrainer):
    """``common.ReferenceTrainer`` over multi-hot slots (module docstring)."""

    def __init__(self, model, cfg: dict, keys: np.ndarray, rows: torch.Tensor, weights: Dict[str, torch.Tensor],
                 **kw):
        super().__init__(model, cfg, keys, rows, weights, **kw)
        self.slot_of = np.repeat(np.arange(cfg["num_slots"]), cfg["multi_hot_sizes"])
        self._present = None  # [B', K] float, 1 where a column holds a key; None: every one does

    def _merge(self, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        if self._present is not None:
            p = self._present[: idx.shape[0]]
            vals = vals * p.reshape(p.shape + (1,) * (vals.dim() - 2))
        return super()._merge(idx, vals)

    def step(self, batch_keys: np.ndarray, labels: torch.Tensor, dense: torch.Tensor):
        """One training step; returns (loss, preds [B])."""
        D = self.cfg["embedx_dim"]
        so = self.cfg["sparse_opt"]
        pw = 3 + D
        B, K = batch_keys.shape
        if K != len(self.slot_of):
            raise ValueError(f"a batch of {K} key columns, the slots hold {len(self.slot_of)}")
        present = batch_keys != 0
        idx = self.rows_of(np.where(present, batch_keys, self.keys[0]))  # [B, K]
        dev = self.table.device
        pres = torch.from_numpy(present.astype(np.float32)).to(dev)
        self._present = None if present.all() else pres
        pooled = torch.zeros((B, self.cfg["num_slots"], pw), dtype=torch.float32, device=dev)
        active = torch.empty((B, K, 1), dtype=torch.float32, device=dev)
        for c in range(K):
            old = self.table[idx[:, c]]  # [B, W]
            active[:, c, 0] = (old[:, SHOW] >= so["embedx_threshold"]).to(torch.float32)
            rec = torch.cat([old[:, :3], old[:, 3:pw] * active[:, c]], dim=1)
            pooled[:, self.slot_of[c]] += rec * pres[:, c, None]
        names = list(self.params)
        with torch.enable_grad():
            p = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
            leaf = pooled.requires_grad_(True)
            logits = self.model.forward(p, cvm(leaf), dense, self.linear)
            n = max(1, int(len(labels) * self.loss_share))
            loss = F.binary_cross_entropy_with_logits(logits[:n], labels[:n])
            grads = torch.autograd.grad(loss, [p[k] for k in names] + [leaf])
        gparams = dict(zip(names, grads[:-1]))
        # a record's gradient is its pooled feature's
        grec = grads[-1][:, torch.from_numpy(self.slot_of).to(dev)]  # [B, K, pw]
        if self.first_grads is None:
            self.first_grads = self._grad_leaves(gparams, grec, idx, active)
        m = self.kept(len(labels))
        self._sparse_update(idx[:m], grec[:m], labels[:m], active[:m])
        self._present = None
        self._adam(gparams)
        return float(loss.detach()), torch.sigmoid(logits.detach())


def run_multihot_reference(model, cfg: dict, keys: np.ndarray, rows: torch.Tensor, weights: Dict[str, torch.Tensor],
                           batches: List[dict], linear: Callable = fp32_linear, loss_share: float = 1.0,
                           step_share: float = 1.0) -> dict:
    """``common.run_reference`` through :class:`MultiHotTrainer`: the same
    readings over ``batches`` (each ``keys`` [B, K] uint64, ``labels``,
    ``dense``)."""
    dev = rows.device
    rt = MultiHotTrainer(model, cfg, keys, rows, weights, linear=linear, loss_share=loss_share,
                         step_share=step_share)
    losses, preds = [], []
    for b in batches:
        loss, p = rt.step(b["keys"], torch.from_numpy(b["labels"]).to(dev), torch.from_numpy(b["dense"]).to(dev))
        losses.append(loss)
        preds.append(p.cpu().numpy())
    D = cfg["embedx_dim"]
    change = {k: rt.params[k] - weights[k].to(torch.float32) for k in rt.params}
    change["table.embed_w"] = rt.table[:, 2] - rows[:, 2]
    change["table.embedx"] = rt.table[:, 3 : 3 + D] - rows[:, 3 : 3 + D]
    change["table.show"] = rt.table[:, SHOW] - rows[:, SHOW]
    change["table.clk"] = rt.table[:, 1] - rows[:, 1]
    kept = rt.kept(len(preds[0]))
    return {
        "losses": losses,
        "preds": preds,
        "grad1": {k: float(torch.linalg.vector_norm(v)) for k, v in rt.first_grads.items()},
        "change": {k: float(torch.linalg.vector_norm(v)) for k, v in change.items()},
        "auc1": auc_buckets(preds[0][:kept], batches[0]["labels"][:kept], cfg["auc_buckets"]),
    }
