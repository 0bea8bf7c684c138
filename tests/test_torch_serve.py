"""The port's serving slice against the JAX package, end to end on the CPU.

The same keys, rows and DeepFM params are committed to a JAX
``ScoringTable`` and to the port's; the same records are scored through
the JAX ``Scorer`` and through the port's ``Scorer(device="cpu")``:

- preds agree within PRED_ATOL (the bf16 MLP sets it: both packages cast
  activations to bf16 per layer, and the two CPU backends round the bf16
  matmul at different places; the measured max |diff| was 6e-8);
- port-vs-port reruns are bitwise equal;
- the port's ``ScoreServer`` answers requests (one with keys absent from
  the version) bitwise-equal to direct scoring, with one
  ``serve.request_ms`` sample per request.
"""

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.data import SlotInfo as JSlotInfo
from paddlebox_tpu.data import SlotSchema as JSlotSchema
from paddlebox_tpu.data.parser import parse_line as jparse_line
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.serve.scoring_table import ScoringTable as JScoringTable
from paddlebox_tpu.serve.server import Scorer as JScorer
from paddlebox_tpu.serve.server import version_source as jversion_source
from paddlebox_tpu.table import ValueLayout as JValueLayout
from paddlebox_tpu.train import TrainStepConfig as JTrainStepConfig
from paddlebox_tpu_torch.data import SlotInfo, SlotSchema, parse_line
from paddlebox_tpu_torch.models import DeepFM, deepfm_params_from_jax
from paddlebox_tpu_torch.serve import ScoreServer, Scorer, ScoringTable, version_source
from paddlebox_tpu_torch.table import ValueLayout
from paddlebox_tpu_torch.train import TrainStepConfig
from paddlebox_tpu_torch.utils.faultinject import InjectedFault, fail_once, inject
from paddlebox_tpu_torch.utils.monitor import STAT_HIST

torch.set_num_threads(2)

S, B, D = 5, 8, 4
HIDDEN = (32, 16)
DATE = "20261016"
PRED_ATOL = 1e-4


def _schema(info_cls, schema_cls):
    return schema_cls(
        [info_cls("label", type="float", dense=True, dim=1)]
        + [info_cls(f"s{i}") for i in range(S)],
        label_slot="label",
    )


def _rows(rng, n, layout):
    """Table rows with show >= clk >= 0, so the CVM logs are finite."""
    rows = (0.3 * rng.standard_normal((n, layout.width))).astype(np.float32)
    show = rng.integers(0, 30, n).astype(np.float32)
    rows[:, 0] = show
    rows[:, 1] = np.floor(show * rng.random(n)).astype(np.float32)
    return rows


def _lines(rng, keys, n, absent=False):
    out = []
    for _ in range(n):
        parts = [f"1 {float(rng.integers(0, 2))}"]
        for _ in range(S):
            k = int(rng.integers(1, 4))
            if absent:
                vals = rng.integers(1 << 40, 1 << 41, k)
            else:
                vals = keys[rng.integers(0, len(keys), k)]
            parts.append(f"{k} " + " ".join(str(int(v)) for v in vals))
        out.append(" ".join(parts))
    return out


class _Follower:
    """The minimal follower a ScoreServer needs: version() and layout."""

    def __init__(self, table, layout):
        self.table = table
        self.layout = layout

    def version(self):
        return self.table.version()


@pytest.fixture(scope="module")
def slice_setup():
    rng = np.random.default_rng(3)
    jlay, lay = JValueLayout(embedx_dim=D), ValueLayout(embedx_dim=D)
    keys = np.sort(rng.choice(10_000, 200, replace=False).astype(np.uint64) + 1)
    rows = _rows(rng, len(keys), lay)

    jmodel = JDeepFM(S, jlay.pull_width, jlay.embedx_dim, hidden=HIDDEN)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jparams = jax.tree.map(lambda a: a + 0.05, jparams)  # nonzero biases too
    np_params = jax.tree.map(np.asarray, jparams)

    jtab = JScoringTable(jlay.width)
    jv = jtab.commit(keys, rows, date=DATE, delta_idx=0, decay_epoch=0, params=jparams)
    tab = ScoringTable(lay.width)
    v = tab.commit(
        keys, rows, date=DATE, delta_idx=0, decay_epoch=0,
        params=deepfm_params_from_jax(np_params),
    )

    jcfg = JTrainStepConfig(num_slots=S, batch_size=B, layout=jlay, auc_buckets=500)
    cfg = TrainStepConfig(num_slots=S, batch_size=B, layout=lay, auc_buckets=500)
    jscorer = JScorer(JDeepFM(S, jlay.pull_width, jlay.embedx_dim, hidden=HIDDEN), jcfg)
    model = DeepFM(
        S, lay.pull_width, lay.embedx_dim, hidden=HIDDEN,
        generator=torch.Generator().manual_seed(0),
    )
    scorer = Scorer(model, cfg, device="cpu")

    lines = _lines(rng, keys, 13) + _lines(rng, keys, 2, absent=True)
    jschema, schema = _schema(JSlotInfo, JSlotSchema), _schema(SlotInfo, SlotSchema)
    return {
        "lay": lay, "jlay": jlay, "jv": jv, "v": v, "tab": tab,
        "jscorer": jscorer, "scorer": scorer,
        "jrecs": [jparse_line(ln, jschema) for ln in lines],
        "recs": [parse_line(ln, schema) for ln in lines],
        "jschema": jschema, "schema": schema,
    }


def _port_scores(st, recs):
    v = st["v"]
    return st["scorer"].score_records(
        recs, st["schema"], version_source(st["lay"], v), v.params
    )


def test_scorer_matches_jax_and_reruns_bitwise(slice_setup):
    st = slice_setup
    jv = st["jv"]
    want = st["jscorer"].score_records(
        st["jrecs"], st["jschema"], jversion_source(st["jlay"], jv), jv.params, jv.opt_state
    )
    got = _port_scores(st, st["recs"])
    assert got.shape == want.shape == (len(st["recs"]),)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_ATOL)
    again = _port_scores(st, st["recs"])
    np.testing.assert_array_equal(got, again)


def test_score_server_answers_requests(slice_setup):
    st = slice_setup
    recs = st["recs"]
    # a full batch, a small one, and one of keys absent from the version
    requests = [recs[:B], recs[B : B + 3], recs[-2:]]
    direct = [_port_scores(st, r) for r in requests]
    h0 = STAT_HIST("serve.request_ms")
    n0 = 0 if h0 is None else h0.count
    srv = ScoreServer(_Follower(st["tab"], st["lay"]), st["scorer"], st["schema"], device="cpu")
    srv.start()
    try:
        answers = [srv.score(r, timeout=60.0) for r in requests]
    finally:
        srv.stop()
    for want, got in zip(direct, answers):
        np.testing.assert_array_equal(want, got)
    assert srv.latency_percentiles()["n"] == len(requests)
    assert STAT_HIST("serve.request_ms").count == n0 + len(requests)



def test_lookup_rows_matches_jax_exactly(slice_setup):
    st = slice_setup
    q = np.concatenate([st["v"].keys[::3], np.array([7, 1 << 45], dtype=np.uint64)])
    want, want_miss = st["jv"].lookup_rows(q)
    got, got_miss = st["v"].lookup_rows(q)
    assert got.tobytes() == want.tobytes() and got_miss == want_miss == 2


def test_commit_is_all_or_nothing(monkeypatch):
    tab = ScoringTable(3)
    v0 = tab.commit(np.array([1, 2], dtype=np.uint64), np.ones((2, 3), np.float32),
                    date=DATE, delta_idx=0, decay_epoch=0)
    with inject(fail_once("serve.apply_delta")):
        with pytest.raises(InjectedFault):
            tab.commit(np.array([5], dtype=np.uint64), np.zeros((1, 3), np.float32),
                       date=DATE, delta_idx=1, decay_epoch=0)
    assert tab.version() is v0 and tab.committed_indices() == [0]
    # a device tier on a host without a GPU and without an explicit device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device scoring tier needs a GPU"):
        tab.commit(np.array([5], dtype=np.uint64), np.zeros((1, 3), np.float32),
                   date=DATE, delta_idx=1, decay_epoch=0, hotness=np.ones(1, np.float32))
    assert tab.version() is v0
