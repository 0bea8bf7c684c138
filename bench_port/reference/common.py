"""The plain reference of one CTR training step, in float32.

Written from the semantics the benchmark holds the program to, and
independent of it: this file imports nothing of the program, and takes
only what the benchmark made (records, initial table rows, dense weights).
It keeps its own table, one row a key, and follows the program's steps:

    rows of the batch's keys -> embedx gate -> CVM -> model -> mean BCE
    -> gradients -> merge by key -> sparse AdaGrad, counters -> Adam

The row layout is ``[show, clk, embed_w, embedx[D], embed_g2, embedx_g2]``;
the model sees the first ``3 + D`` columns. The sparse optimizer: show and
clk add the key's occurrences and clicks; embed_w takes AdaGrad with
``g2 += g**2`` and step ``lr * sqrt(g2_0 / (g2_0 + g2)) * g``; embedx the
same with one g2 scalar that adds the mean of the squared gradient, its
gradient zero while the key's show is under ``embedx_threshold``; both
clipped to ``[-weight_bounds, weight_bounds]``. The dense optimizer is
Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected).

``linear`` is the tower's matrix product. :func:`fp32_linear` is the
reference's; :func:`fp8_linear` is the control's: the product of e4m3
operands (per-tensor scale) whose backward takes the output gradient in
e5m2, a tower one precision below the bf16 the configurations state.
Two shares below 1 plant faults for calibration: with ``step_share`` a
step sees only the batch's first share of samples (its loss is their
mean; its counters and its AUC count only them; its forward still makes
every prediction); with ``loss_share`` only the loss leaves the rest
out.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

SHOW, CLK, EMBED_W = 0, 1, 2
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
FP8_E4M3_MAX, FP8_E5M2_MAX = 448.0, 57344.0


def fp32_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x @ w.t() + b


def _fake_quant(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xq = _fake_quant(x, torch.float8_e4m3fn, FP8_E4M3_MAX)
        wq = _fake_quant(w, torch.float8_e4m3fn, FP8_E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.t() + b

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = _fake_quant(gy, torch.float8_e5m2, FP8_E5M2_MAX)
        return gq @ wq, gq.t() @ xq, gy.sum(0)


def fp8_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Linear.apply(x, w, b)


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, n_layers: int, linear: Callable) -> torch.Tensor:
    """ReLU after every layer, the last one's too."""
    h = x
    for i in range(n_layers):
        h = torch.relu(linear(h, params[f"mlp.{i}.weight"], params[f"mlp.{i}.bias"]))
    return h


def cvm(rec: torch.Tensor) -> torch.Tensor:
    """[..., show, clk, rest] -> [log(show + 1), log(clk + 1) - log(show + 1), rest]."""
    log_show = torch.log(rec[..., SHOW : SHOW + 1] + 1.0)
    log_clk = torch.log(rec[..., CLK : CLK + 1] + 1.0)
    return torch.cat([log_show, log_clk - log_show, rec[..., 2:]], dim=-1)


def auc_buckets(preds: np.ndarray, labels: np.ndarray, n_buckets: int):
    """Positive and negative counts a prediction bucket: bucket
    ``clamp(int(p * n), 0, n - 1)``."""
    b = np.clip((preds.astype(np.float32) * np.float32(n_buckets)).astype(np.int64), 0, n_buckets - 1)
    pos = np.bincount(b[labels > 0.5], minlength=n_buckets).astype(np.float64)
    neg = np.bincount(b[labels <= 0.5], minlength=n_buckets).astype(np.float64)
    return pos, neg


def auc_from_buckets(pos: np.ndarray, neg: np.ndarray) -> float:
    """P(a positive's bucket is above a negative's), ties counting half."""
    cum = np.cumsum(pos)
    p, n = cum[-1], neg.sum()
    if p <= 0 or n <= 0:
        return 0.5
    return float(np.sum(neg * ((p - cum) + pos / 2.0)) / (p * n))


class ReferenceTrainer:
    """The plain reference over the keys of a few batches.

    ``keys`` are the sorted distinct keys the batches use and ``rows``
    their initial rows (float32 [n, 5 + D]); ``weights`` the dense
    params by name; ``forward(params, feats [B, S, 3 + D], dense, linear)``
    the model's logits."""

    def __init__(self, model, cfg: dict, keys: np.ndarray, rows: torch.Tensor, weights: Dict[str, torch.Tensor],
                 linear: Callable = fp32_linear, loss_share: float = 1.0, step_share: float = 1.0):
        self.model = model
        self.cfg = cfg
        self.linear = linear
        self.loss_share = min(loss_share, step_share)
        self.step_share = step_share
        self.keys = keys
        self.table = rows.to(torch.float32).clone()
        self.params = {k: v.to(torch.float32).clone() for k, v in weights.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None

    def kept(self, batch: int) -> int:
        """How many of a batch's samples the step sees."""
        return max(1, int(batch * self.step_share))

    def rows_of(self, batch_keys: np.ndarray) -> torch.Tensor:
        pos = np.searchsorted(self.keys, batch_keys)
        if np.any(self.keys[np.minimum(pos, len(self.keys) - 1)] != batch_keys):
            raise ValueError("a batch key is not among the reference's keys")
        return torch.from_numpy(pos.astype(np.int64)).to(self.table.device)

    def step(self, batch_keys: np.ndarray, labels: torch.Tensor, dense: Optional[torch.Tensor]):
        """One training step; returns (loss, preds [B])."""
        D = self.cfg["embedx_dim"]
        so = self.cfg["sparse_opt"]
        pw = 3 + D
        idx = self.rows_of(batch_keys)  # [B, S]
        old = self.table[idx]  # [B, S, W]
        active = (old[..., SHOW] >= so["embedx_threshold"]).to(torch.float32)[..., None]
        rec = torch.cat([old[..., :3], old[..., 3:pw] * active], dim=-1)
        names = list(self.params)
        with torch.enable_grad():
            p = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
            leaf = rec.detach().requires_grad_(True)
            logits = self.model.forward(p, cvm(leaf), dense, self.linear)
            n = max(1, int(len(labels) * self.loss_share))
            loss = F.binary_cross_entropy_with_logits(logits[:n], labels[:n])
            grads = torch.autograd.grad(loss, [p[k] for k in names] + [leaf])
        gparams = dict(zip(names, grads[:-1]))
        grec = grads[-1]
        if self.first_grads is None:
            self.first_grads = self._grad_leaves(gparams, grec, idx, active)
        m = self.kept(len(labels))
        self._sparse_update(idx[:m], grec[:m], labels[:m], active[:m])
        self._adam(gparams)
        return float(loss.detach()), torch.sigmoid(logits.detach())

    def _merge(self, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.table.shape[0],) + vals.shape[2:], dtype=torch.float32, device=vals.device)
        return out.index_add_(0, idx.reshape(-1), vals.reshape((-1,) + vals.shape[2:]))

    def _grad_leaves(self, gparams, grec, idx, active) -> Dict[str, torch.Tensor]:
        """The first step's gradients by leaf: the dense params and the
        table's embed_w and embedx blocks, merged by key."""
        D = self.cfg["embedx_dim"]
        g = dict(gparams)
        g["table.embed_w"] = self._merge(idx, grec[..., EMBED_W])
        g["table.embedx"] = self._merge(idx, grec[..., 3 : 3 + D] * active)
        return g

    def _sparse_update(self, idx, grec, labels, active) -> None:
        D = self.cfg["embedx_dim"]
        so = self.cfg["sparse_opt"]
        t = self.table
        g_w = self._merge(idx, grec[..., EMBED_W])  # [n]
        g_x = self._merge(idx, grec[..., 3 : 3 + D] * active)  # [n, D]
        occ = self._merge(idx, torch.ones(idx.shape, dtype=torch.float32, device=t.device))
        clk = self._merge(idx, labels[:, None].expand(idx.shape).contiguous())
        x_active = (t[:, SHOW] >= so["embedx_threshold"]).to(torch.float32)[:, None]
        g_x = g_x * x_active
        gw_col, gx_col = 3 + D, 4 + D
        g2_e = t[:, gw_col] + g_w * g_w
        g2_x = t[:, gx_col] + torch.mean(g_x * g_x, dim=1)
        g0, lr_e, lr_x, wb = so["initial_g2sum"], so["embed_lr"], so["embedx_lr"], so["weight_bounds"]
        new_w = t[:, EMBED_W] - lr_e * torch.sqrt(g0 / (g0 + g2_e)) * g_w
        new_x = t[:, 3 : 3 + D] - (lr_x * torch.sqrt(g0 / (g0 + g2_x)))[:, None] * g_x
        self.table = torch.cat([
            (t[:, SHOW] + occ)[:, None], (t[:, CLK] + clk)[:, None],
            new_w.clamp(-wb, wb)[:, None], new_x.clamp(-wb, wb),
            g2_e[:, None], g2_x[:, None],
        ], dim=1)

    def _adam(self, gparams) -> None:
        lr = self.cfg["dense_lr"]
        self.count += 1
        bc1, bc2 = 1 - ADAM_B1**self.count, 1 - ADAM_B2**self.count
        for k, g in gparams.items():
            self.mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * self.mu[k]
            self.nu[k] = (1 - ADAM_B2) * g * g + ADAM_B2 * self.nu[k]
            self.params[k] = self.params[k] - lr * ((self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + ADAM_EPS))


def _step(rt: ReferenceTrainer, b: dict, dev):
    labels = torch.from_numpy(b["labels"]).to(dev)
    dense = None if b["dense"] is None else torch.from_numpy(b["dense"]).to(dev)
    return rt.step(b["keys"], labels, dense)


def run_reference(model, cfg: dict, keys: np.ndarray, rows: torch.Tensor, weights: Dict[str, torch.Tensor],
                  batches: List[dict], linear: Callable = fp32_linear, loss_share: float = 1.0,
                  step_share: float = 1.0) -> dict:
    """The reference over ``batches`` (each ``keys`` [B, S] uint64,
    ``labels`` float32 [B], ``dense`` or None), in order. Returns its
    readings: the losses and preds of every step, the first step's
    gradients by leaf, the change of every leaf over the steps, and the
    first step's AUC bucket tables (positive, negative counts)."""
    dev = rows.device
    rt = ReferenceTrainer(model, cfg, keys, rows, weights, linear, loss_share, step_share)
    losses, preds = [], []
    for b in batches:
        loss, p = _step(rt, b, dev)
        losses.append(loss)
        preds.append(p.cpu().numpy())
    D = cfg["embedx_dim"]
    change = {k: rt.params[k] - weights[k].to(torch.float32) for k in rt.params}
    change["table.embed_w"] = rt.table[:, EMBED_W] - rows[:, EMBED_W]
    change["table.embedx"] = rt.table[:, 3 : 3 + D] - rows[:, 3 : 3 + D]
    change["table.show"] = rt.table[:, SHOW] - rows[:, SHOW]
    change["table.clk"] = rt.table[:, CLK] - rows[:, CLK]
    return {
        "losses": losses,
        "preds": preds,
        "grad1": {k: float(torch.linalg.vector_norm(v)) for k, v in rt.first_grads.items()},
        "change": {k: float(torch.linalg.vector_norm(v)) for k, v in change.items()},
        "auc1": auc_buckets(preds[0][: rt.kept(len(preds[0]))], batches[0]["labels"][: rt.kept(len(preds[0]))],
                            cfg["auc_buckets"]),
    }
