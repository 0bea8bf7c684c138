"""The program under test, built from a configuration: the port's host
table, pass dataset and trainer, and the readings of its first steps.

What the benchmark makes itself and hands to both the program and the
reference: the records (``core/traffic.py``), the initial rows of every
key of a pass, and the dense weights. Both are drawn on the device from
the seed in a few large calls.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

ADAM_B1 = 0.9  # the configurations' Adam; its first moment gives the first gradient


def layout(cfg: dict):
    from paddlebox_tpu_torch.table import ValueLayout

    return ValueLayout(embedx_dim=cfg["embedx_dim"])


def sparse_opt(cfg: dict):
    from paddlebox_tpu_torch.table import SparseOptimizerConfig

    return SparseOptimizerConfig(**cfg["sparse_opt"])


def schema(cfg: dict):
    from paddlebox_tpu_torch.data import SlotInfo, SlotSchema

    dense = [SlotInfo("dense", type="float", dense=True, dim=cfg["dense_dim"])] if cfg["dense_dim"] else []
    return SlotSchema(
        [SlotInfo("label", type="float", dense=True, dim=1)] + dense
        + [SlotInfo(f"s{i}") for i in range(cfg["num_slots"])],
        label_slot="label",
    )


def init_rows(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    """``n`` table rows as a host table holds them after earlier days:
    show log-uniform in [1, e^show_log_max), clk a share of it up to
    ``ctr_max``, embed_w uniform in +-embed_range, embedx normal with that
    deviation, both g2 sums 0. float32 [n, 5 + D] on ``device``."""
    ti, D = cfg["table_init"], cfg["embedx_dim"]
    g = torch.Generator(device=device).manual_seed(seed ^ 0x5EED_0001)
    u = torch.rand((n, 3), generator=g, device=device)
    show = torch.floor(torch.exp(u[:, 0] * ti["show_log_max"]))
    clk = torch.floor(show * u[:, 1] * ti["ctr_max"])
    w = (u[:, 2] * 2 - 1) * ti["embed_range"]
    x = torch.randn((n, D), generator=g, device=device) * ti["embed_range"]
    z = torch.zeros((n, 2), device=device)
    return torch.cat([show[:, None], clk[:, None], w[:, None], x, z], dim=1)


def make_weights(shapes: Sequence[Tuple[str, tuple]], cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The dense params from one normal draw: weights N(0, 2 / (in + out)),
    biases N(0, 1e-4), the logit bias ``b`` the log-odds of ``ctr_prior``."""
    g = torch.Generator(device=device).manual_seed(seed ^ 0x5EED_0002)
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn((total,), generator=g, device=device)
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        v = flat[off : off + n].reshape(shape)
        off += n
        if name == "b":
            p = cfg["ctr_prior"]
            v = torch.full(shape, math.log(p / (1 - p)), device=device)
        elif len(shape) == 2:
            v = v * math.sqrt(2.0 / (shape[0] + shape[1]))
        else:
            v = v * 0.01
        out[name] = v.contiguous()
    return out


def host_table(cfg: dict, seed: int, keys: np.ndarray, rows: np.ndarray):
    """The port's native host table holding ``rows`` for ``keys``."""
    from paddlebox_tpu_torch.table import HostSparseTable

    table = HostSparseTable(layout(cfg), sparse_opt(cfg), n_shards=64, seed=seed)
    if not table.native:
        raise RuntimeError("the host table is not on the native store")
    table.push(keys, np.ascontiguousarray(rows, dtype=np.float32))
    return table


def dataset(cfg: dict, mix: dict, table, files: List[str], seed: int):
    """A pass dataset over ``files`` on the native tier, records in file
    order (no shuffle: the traffic is drawn in random order)."""
    from paddlebox_tpu_torch.data import BoxPSDataset

    ds = BoxPSDataset(schema(cfg), table, batch_size=mix["batch"], shuffle_mode="none", seed=seed,
                      read_threads=mix["read_threads"])
    ds.set_filelist(files)
    return ds


def trainer(cfg: dict, mix: dict, model_mod, weights: Dict[str, torch.Tensor], device):
    """A ``CTRTrainer`` on ``device`` whose dense params are ``weights``."""
    from paddlebox_tpu_torch.train import Adam, CTRTrainer, TrainStepConfig

    lay = layout(cfg)
    model = model_mod.build(cfg, lay)
    model.load_state_dict({k: v.detach().cpu() for k, v in weights.items()}, strict=True)
    step_cfg = TrainStepConfig(num_slots=cfg["num_slots"], batch_size=mix["batch"], layout=lay,
                               sparse_opt=sparse_opt(cfg), auc_buckets=cfg["auc_buckets"])
    dense = {"dense_slot": "dense", "dense_dim": cfg["dense_dim"]} if cfg["dense_dim"] else {}
    tr = CTRTrainer(model, step_cfg, dense_opt=Adam(cfg["dense_lr"]), device=device, **dense)
    tr.init_params()
    return tr


def _sumsq(t: torch.Tensor) -> torch.Tensor:
    return torch.sum(t.to(torch.float64) ** 2)


def _rows_of(table: torch.Tensor, ds, keys: np.ndarray) -> torch.Tensor:
    """Rows of ``keys`` in ``table``."""
    ws = ds.ws
    pos = np.searchsorted(ws.sorted_keys, keys)
    if np.any(ws.sorted_keys[np.minimum(pos, len(ws.sorted_keys) - 1)] != keys):
        raise RuntimeError("a checked key is not in the program's pass")
    rows = ws.row_of_sorted[pos].astype(np.int64)
    return table.index_select(0, torch.from_numpy(rows).to(table.device))


def _auc_tables(tr) -> Tuple[np.ndarray, np.ndarray]:
    """The trainer's AUC bucket tables (positive, negative counts) as they
    stand, float64 on the host; zeros before its first step."""
    state = tr._state  # the trainer's live training state
    if state is None:
        n = tr.cfg.auc_buckets
        return np.zeros(n), np.zeros(n)
    return (state.auc.pos.cpu().numpy().astype(np.float64), state.auc.neg.cpu().numpy().astype(np.float64))


def first_steps(tr, ds, cfg: dict, keys: np.ndarray, rows0: torch.Tensor,
                weights: Dict[str, torch.Tensor], later: int) -> dict:
    """Drive the trainer through its first steps with the window's own
    call and feed, and read them: ``train_pass`` over the pass's first
    batch (one step), then over its first ``later`` (``train_pass``
    starts a pass at its first batch, so the second call's first step
    retrains it). ``keys`` are the distinct keys of those batches and
    ``rows0`` their initial rows. The readings have the reference's
    structure; ``auc1`` is the first step's AUC bucket tables."""
    D = cfg["embedx_dim"]
    losses, preds = [], []

    def on_batch(i, m):
        losses.append(float(m["loss"]))
        preds.append(m["preds"].detach().float().cpu().numpy())

    def trained_rows():
        return _rows_of(tr.trained_table_device(), ds, keys)

    def norms(sumsqs: Dict[str, torch.Tensor]) -> Dict[str, float]:
        return {k: float(v) ** 0.5 for k, v in sumsqs.items()}

    pos0, neg0 = _auc_tables(tr)
    tr.train_pass(ds, n_batches=1, on_batch=on_batch)
    pos1, neg1 = _auc_tables(tr)
    grad1 = {k: float(torch.linalg.vector_norm(mu.float())) / (1 - ADAM_B1) for k, mu in tr.opt_state.mu.items()}
    t1 = trained_rows()
    grad1.update(norms({
        # g2 sums start at 0: after one step they hold g**2 and mean(g**2)
        "table.embed_w": torch.sum((t1[:, 3 + D] - rows0[:, 3 + D]).clamp(min=0).double()),
        "table.embedx": torch.sum((t1[:, 4 + D] - rows0[:, 4 + D]).clamp(min=0).double()) * D,
    }))
    tr.train_pass(ds, n_batches=later, on_batch=on_batch)
    t_end = trained_rows()
    change = {k: float(torch.linalg.vector_norm((tr.params[k] - weights[k]).float())) for k in weights}
    change.update(norms({
        "table.embed_w": _sumsq(t_end[:, 2] - rows0[:, 2]),
        "table.embedx": _sumsq(t_end[:, 3 : 3 + D] - rows0[:, 3 : 3 + D]),
        "table.show": _sumsq(t_end[:, 0] - rows0[:, 0]),
        "table.clk": _sumsq(t_end[:, 1] - rows0[:, 1]),
    }))
    return {"losses": losses, "preds": preds, "grad1": grad1, "change": change,
            "auc1": (pos1 - pos0, neg1 - neg0)}
