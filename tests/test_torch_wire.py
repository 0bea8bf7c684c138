"""The port's boundary row wire against the JAX package's, bitwise.

``fetch_rows`` (device -> host), ``send_rows`` (host -> device) and
``row_wire_nbytes`` under fp32, bf16 and int8, with and without an expand
block, on rows that hold rounding ties (for bf16, and for int8 after the
per-row divide), subnormals, +-inf and NaN. A NaN stays a NaN but its
payload is not part of the contract (torch, ml_dtypes and XLA each pick
their own quiet NaN), so NaNs are compared by position and every other
value by its bits. The ``wire.*`` counters move as the JAX package's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.ops import wire_quant as jwire
from paddlebox_tpu.table.value_layout import ValueLayout as JValueLayout
from paddlebox_tpu.utils import monitor as jmonitor
from paddlebox_tpu_torch.ops import wire_quant as wire
from paddlebox_tpu_torch.table.value_layout import ValueLayout
from paddlebox_tpu_torch.utils import monitor

torch.set_num_threads(2)

MODES = ("fp32", "bf16", "int8")
LAYOUTS = {"plain": dict(embedx_dim=4), "expand": dict(embedx_dim=4, expand_embed_dim=3)}


def _rows(lay, n=64, seed=0):
    """Random rows of every magnitude, then rows with the edge cases."""
    rng = np.random.default_rng(seed)
    w = lay.width
    x = rng.standard_normal((n, w)).astype(np.float32)
    x *= rng.choice(np.float32([1e-3, 1.0, 1e3]), (n, 1))
    x[:, lay.SHOW] = rng.integers(0, 1000, n)
    a, b = lay.embed_w_col, lay.embed_g2_col
    # bf16 ties: the low 16 bits are exactly half an ulp, odd and even
    x[0] = (np.arange(w, dtype=np.uint32) * 0x10000 + 0x3F808000).view(np.float32)
    x[1] = (np.arange(w, dtype=np.uint32) * 0x10000 + 0x3F818000).view(np.float32)
    # int8 ties: max 127 makes the scale 1, so x / scale sits on .5
    x[2, a:b] = np.float32([127.0, 0.5, 1.5, -2.5, -0.5, 3.5, 126.5, -126.5][: b - a] + [0.0] * max(0, b - a - 8))
    x[3, a:b] = -x[2, a:b]
    # subnormals beside normals, and a block of subnormals only
    x[4] = np.float32([1e-40, -3e-39, 1.0, 2e-45] * w)[:w]
    x[5, a:b] = np.float32(1e-40)
    x[5, :a] = np.float32(-7e-41)
    # non-finite values in each region
    x[6, lay.CLK] = np.inf
    x[7, a + 1] = -np.inf
    x[8, a] = np.nan
    x[9, b] = np.nan
    x[10, :] = np.inf
    x[11, lay.SHOW] = -np.nan
    x[12] = 0.0
    x[13] = -0.0
    return x


def _assert_bits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.uint32)[~nan], want.view(np.uint32)[~nan])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", LAYOUTS)
def test_fetch_rows_matches_jax_bitwise(mode, kind):
    lay, jlay = ValueLayout(**LAYOUTS[kind]), JValueLayout(**LAYOUTS[kind])
    x = _rows(lay)
    want = jwire.fetch_rows(jnp.asarray(x), jlay, mode)
    got = wire.fetch_rows(torch.from_numpy(x.copy()), lay, mode)
    assert got.dtype == np.float32
    _assert_bits(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", LAYOUTS)
def test_send_rows_matches_jax_bitwise(mode, kind):
    lay, jlay = ValueLayout(**LAYOUTS[kind]), JValueLayout(**LAYOUTS[kind])
    x = _rows(lay, seed=1)
    want = np.asarray(jwire.send_rows(x, jlay, mode))
    got = wire.send_rows(x, lay, mode, "cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _assert_bits(got.numpy(), want)


@pytest.mark.parametrize("kind", LAYOUTS)
def test_wire_nbytes_and_counters_match_jax(kind):
    lay, jlay = ValueLayout(**LAYOUTS[kind]), JValueLayout(**LAYOUTS[kind])
    for mode in MODES:
        for n in (0, 1, 1000):
            assert wire.row_wire_nbytes(n, lay, mode) == jwire.row_wire_nbytes(n, jlay, mode)
    names = [f"wire.{d}_{k}_total" for d in ("fetch", "send") for k in ("rows", "bytes", "fp32_bytes")]
    x = _rows(lay)[16:]
    before = {n: (monitor.STAT_GET(n), jmonitor.STAT_GET(n)) for n in names}
    for mode in MODES:
        wire.fetch_rows(torch.from_numpy(x), lay, mode)
        wire.send_rows(x, lay, mode, "cpu")
        jwire.fetch_rows(jnp.asarray(x), jlay, mode)
        jwire.send_rows(x, jlay, mode)
    for n in names:
        assert monitor.STAT_GET(n) - before[n][0] == jmonitor.STAT_GET(n) - before[n][1] > 0


def test_fetch_handle_holds_the_rows_of_its_start():
    """A fetch started before the source changes returns the rows as they
    were at the start, in every mode (the departing slice is fetched while
    the next pass trains)."""
    lay = ValueLayout(embedx_dim=4)
    x = _rows(lay)[16:]
    for mode in MODES:
        src = torch.from_numpy(x.copy())
        want = wire.fetch_rows(src.clone(), lay, mode)
        h = wire.fetch_rows_start(src if mode != "fp32" else src.clone(), lay, mode)
        src.mul_(3.0)
        _assert_bits(wire.fetch_rows_finish(h, lay), want)


def test_unknown_mode_raises():
    lay = ValueLayout(embedx_dim=4)
    with pytest.raises(ValueError, match="wire dtype"):
        wire.fetch_rows(torch.zeros((1, lay.width)), lay, "fp8")
    with pytest.raises(ValueError, match="wire dtype"):
        wire.row_wire_nbytes(1, lay, "int4")
