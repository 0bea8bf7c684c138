"""The port's training step against the JAX package's, step for step.

Both start from one state (the JAX DeepFM's weights carried across with
``deepfm_params_from_jax``, zero Adam moments, one table) and take three
steps on identical packed batches. The MLPs run their bf16 recipe, which
rounds at other places in XLA's and torch's CPU dots, and the per-row
gradient sums may add in another order. Tolerances, each with the largest
difference measured at these sizes:

- table: rtol 1e-3, atol 1e-5 (measured max |diff| 1.5e-5, on a value
  of ~5e-3);
- params: atol 2e-4. Adam divides each moment by its own root-mean-square,
  so a gradient element near zero whose bf16 rounding differs between the
  two can move its weight by up to lr = 1e-3 per step; the bound sits at
  8x the measured max |diff| (2.4e-5) and under that worst case;
- Adam moments: rtol 5e-2, atol 1e-6 (measured max relative diff 0.099,
  on an element of ~1e-7, inside the atol);
- loss: rtol 1e-3 (measured 1.6e-5); AUC bucket tables: exact.

The port against itself (the twin) is bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.metrics.auc import auc_init as jauc_init
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.table.optimizers import SparseOptimizerConfig as JSparseOptimizerConfig
from paddlebox_tpu.table.value_layout import ValueLayout as JValueLayout
from paddlebox_tpu.train.train_step import TrainState as JTrainState
from paddlebox_tpu.train.train_step import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu.train.train_step import make_train_step as jmake_train_step
from paddlebox_tpu_torch.metrics.auc import auc_init
from paddlebox_tpu_torch.models import (
    DeepFM,
    adam_state_from_optax,
    adam_state_to_optax,
    deepfm_params_from_jax,
    deepfm_params_to_jax,
)
from paddlebox_tpu_torch.table import SparseOptimizerConfig, ValueLayout
from paddlebox_tpu_torch.train import Adam, TrainState, TrainStepConfig, make_train_step

torch.set_num_threads(2)

S, B, D = 5, 16, 4
HIDDEN = (32, 16)
R = 96  # table rows; the last is the padding row
LR = 1e-3
AUC_BUCKETS = 50
TABLE_RTOL, TABLE_ATOL = 1e-3, 1e-5
PARAMS_ATOL = 2e-4
MOMENT_RTOL, MOMENT_ATOL = 5e-2, 1e-6
LOSS_RTOL = 1e-3


def _batch(rng, n_uniq=40):
    """A packed batch: unique rows + padding-row tail, slot-major segments
    with pads in the trash segment, and the inverse map."""
    uniq = rng.permutation(R - 1)[:n_uniq].astype(np.int32)
    lens = rng.integers(1, 3, S * B)
    segments = np.repeat(np.arange(S * B, dtype=np.int32), lens)
    L = len(segments)
    U_pad, L_pad = n_uniq + 8, L + 6
    return {
        "uniq_rows": np.concatenate([uniq, np.full(U_pad - n_uniq, R - 1, np.int32)]),
        "inverse": np.concatenate(
            [rng.integers(0, n_uniq, L), np.full(L_pad - L, U_pad - 1)]
        ).astype(np.int32),
        "segments": np.concatenate([segments, np.full(L_pad - L, S * B)]).astype(np.int32),
        "labels": (rng.random(B) < 0.4).astype(np.float32),
    }


def _table(rng, lay):
    table = (0.1 * rng.normal(size=(R, lay.width))).astype(np.float32)
    table[:, 0] = rng.integers(0, 30, R)
    table[:, 1] = np.floor(table[:, 0] * rng.random(R))
    table[:, lay.embed_g2_col :] = 0.0
    table[R - 1] = 0.0
    return table


class Both:
    """One config run through the JAX step and the port's step."""

    def __init__(self, seed=0, n_steps=3, **cfg_kw):
        self.lay, jlay = ValueLayout(embedx_dim=D), JValueLayout(embedx_dim=D)
        rng = np.random.default_rng(seed)
        self.table0 = _table(rng, self.lay)
        self.batches = [_batch(rng) for _ in range(n_steps)]
        jmodel = JDeepFM(S, self.lay.pull_width, D, hidden=HIDDEN)
        self.jparams = jax.tree.map(lambda a: a + 0.02, jmodel.init(jax.random.PRNGKey(seed)))
        self.model = DeepFM(
            S, self.lay.pull_width, D, hidden=HIDDEN, generator=torch.Generator().manual_seed(seed)
        )
        self.model.load_state_dict(deepfm_params_from_jax(jax.tree.map(np.asarray, self.jparams)))
        sp = dict(embedx_threshold=5.0)
        self.jcfg = JTrainStepConfig(
            num_slots=S, batch_size=B, layout=jlay, sparse_opt=JSparseOptimizerConfig(**sp),
            auc_buckets=AUC_BUCKETS, **cfg_kw,
        )
        self.cfg = TrainStepConfig(
            num_slots=S, batch_size=B, layout=self.lay, sparse_opt=SparseOptimizerConfig(**sp),
            auc_buckets=AUC_BUCKETS, **cfg_kw,
        )
        self.jopt = optax.adam(LR)
        self.jstep = jax.jit(jmake_train_step(jmodel.apply, self.jopt, self.jcfg))
        self.step = make_train_step(
            lambda p, x, d: torch.func.functional_call(self.model, p, (x, d)), self.cfg, Adam(LR)
        )

    def run_jax(self, batches=None):
        st = JTrainState(
            jnp.asarray(self.table0), self.jparams, self.jopt.init(self.jparams),
            jauc_init(AUC_BUCKETS), jnp.zeros((), jnp.int32),
        )
        ms = []
        for b in batches or self.batches:
            st, m = self.jstep(st, {k: jnp.asarray(v) for k, v in b.items()})
            ms.append(m)
        return st, ms

    def port_state(self):
        params = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        return TrainState(
            torch.from_numpy(self.table0.copy()), params, Adam(LR).init(params),
            auc_init(AUC_BUCKETS, device="cpu"), torch.zeros((), dtype=torch.int32),
        )

    def run_port(self, batches=None):
        st = self.port_state()
        ms = []
        for b in batches or self.batches:
            st, m = self.step(st, {k: torch.from_numpy(v) for k, v in b.items()})
            ms.append(m)
        return st, ms


def _assert_close(st, jst, ms, jms):
    np.testing.assert_allclose(st.table.numpy(), np.asarray(jst.table), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    want_p = jax.tree.map(np.asarray, jst.params)
    got_p = deepfm_params_to_jax(st.params)
    for g, w in zip(jax.tree.leaves(got_p), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAMS_ATOL)
    jadam = jst.opt_state[0]
    count, mu, nu = adam_state_to_optax(st.opt_state)
    assert int(count) == int(jadam.count)
    for got, want in ((mu, jadam.mu), (nu, jadam.nu)):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(g, w, rtol=MOMENT_RTOL, atol=MOMENT_ATOL)
    np.testing.assert_array_equal(st.auc.pos.numpy(), np.asarray(jst.auc.pos))
    np.testing.assert_array_equal(st.auc.neg.numpy(), np.asarray(jst.auc.neg))
    assert int(st.step) == int(jst.step)
    for m, jm in zip(ms, jms):
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)


@pytest.mark.parametrize(
    "cfg_kw",
    [
        {},
        {"slot_lr": (1.0, 0.5, 2.0, 1.0, 0.25)},
        {"adjust_ins_weight": (1, 20.0, 2.0)},
        {"dense_sync_mode": "kstep", "check_nan": True},
    ],
    ids=["plain", "slot_lr", "adjust_ins_weight", "kstep_check_nan"],
)
def test_three_steps_match_jax(cfg_kw):
    both = Both(**cfg_kw)
    jst, jms = both.run_jax()
    st, ms = both.run_port()
    _assert_close(st, jst, ms, jms)
    if "check_nan" in cfg_kw:
        assert all(int(m["nan_skipped"]) == 0 for m in ms)


def test_check_nan_skips_the_batch_like_jax():
    both = Both(n_steps=2, check_nan=True)
    bad = dict(both.batches[1])
    bad["labels"] = bad["labels"].copy()
    bad["labels"][3] = np.nan  # a NaN label poisons the loss and the grads
    batches = [both.batches[0], bad]
    jst, jms = both.run_jax(batches)
    st0, _ = both.run_port(batches[:1])
    table_after_one = st0.table.clone()
    st, ms = both.run_port(batches)
    assert int(ms[1]["nan_skipped"]) == 1 == int(jms[1]["nan_skipped"])
    # the skipped batch leaves the table bitwise as the first step left it
    assert torch.equal(st.table, table_after_one)
    assert int(st.step) == 1 == int(jst.step)
    assert int(st.opt_state.count) == 1
    np.testing.assert_allclose(st.table.numpy(), np.asarray(jst.table), rtol=TABLE_RTOL, atol=TABLE_ATOL)
    np.testing.assert_array_equal(st.auc.pos.numpy(), np.asarray(jst.auc.pos))
    np.testing.assert_array_equal(st.auc.neg.numpy(), np.asarray(jst.auc.neg))


def test_port_twin_is_bitwise():
    both = Both(slot_lr=(1.0, 0.5, 2.0, 1.0, 0.25))
    a, ma = both.run_port()
    b, mb = both.run_port()
    assert torch.equal(a.table, b.table)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k])
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k])
    assert all(torch.equal(x["loss"], y["loss"]) for x, y in zip(ma, mb))


def test_adam_state_round_trips_through_optax_layout():
    both = Both(n_steps=1)
    jst, _ = both.run_jax()
    jadam = jax.tree.map(np.asarray, jst.opt_state[0])
    st = adam_state_from_optax(jadam.count, jadam.mu, jadam.nu)
    count, mu, nu = adam_state_to_optax(st)
    assert int(count) == int(jadam.count) == 1
    for got, want in ((mu, jadam.mu), (nu, jadam.nu)):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w)


def test_eval_step_still_leaves_state_as_it_came():
    both = Both(n_steps=1)
    step = make_train_step(
        lambda p, x, d: torch.func.functional_call(both.model, p, (x, d)), both.cfg, eval_mode=True
    )
    st = both.port_state()
    table = st.table.clone()
    new, m = step(st, {k: torch.from_numpy(v) for k, v in both.batches[0].items()})
    assert new.table is st.table and new.params is st.params
    assert torch.equal(st.table, table)
    assert m["preds"].shape == (B,)
