"""The port's row gather, row writeback and sparse pull against the JAX
package.

On the CPU the gather and the writeback take their plain versions,
``pull_rows_ref`` and ``write_rows_ref``; each is held exactly against its
TPU kernel (``pull_rows_pallas``, ``write_rows_pallas``) run in interpret
mode. The CUDA kernels themselves run only on a card: ``chip_smoke.py``
holds them bitwise against their plain versions there (this suite imports
jax, which the card's machine does not have).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.ops.pallas_kernels import pull_rows_pallas, write_rows_pallas
from paddlebox_tpu.ops.pull_push import pull_sparse_rows as jpull_sparse_rows
from paddlebox_tpu.table.value_layout import FeatureType as JFeatureType
from paddlebox_tpu.table.value_layout import ValueLayout as JValueLayout
from paddlebox_tpu_torch.ops import cuda_kernels as ck
from paddlebox_tpu_torch.ops.pull_push import pull_sparse_rows
from paddlebox_tpu_torch.table.value_layout import FeatureType, ValueLayout

torch.set_num_threads(2)


@pytest.mark.parametrize("width", [22, 21])
def test_gather_ref_matches_pallas_exactly(width):
    rng = np.random.default_rng(width)
    table = rng.normal(size=(128, width)).astype(np.float32)
    rows = rng.integers(0, 128, 64).astype(np.int32)
    rows[::7] = rows[0]  # duplicates
    want = np.asarray(pull_rows_pallas(jnp.asarray(table), jnp.asarray(rows), interpret=True))
    got = ck.pull_rows_ref(torch.from_numpy(table), torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_kernel_refuses_cpu_tensors():
    table = torch.zeros((4, 3))
    before = ck.launch_counts["pull_rows_cuda"]
    with pytest.raises(ValueError, match="CUDA table"):
        ck.pull_rows_cuda(table, torch.zeros(2, dtype=torch.int32))
    assert ck.launch_counts["pull_rows_cuda"] == before


@pytest.mark.parametrize("width", [1, 20, 21])
def test_writeback_ref_matches_pallas_exactly(width):
    rng = np.random.default_rng(width)
    table = rng.normal(size=(96, width)).astype(np.float32)
    uniq = rng.permutation(95)[:24].astype(np.int32)
    new = rng.normal(size=(24, width)).astype(np.float32)
    want = np.asarray(
        write_rows_pallas(jnp.asarray(table), jnp.asarray(uniq), jnp.asarray(new), interpret=True)
    )
    got_t = torch.from_numpy(table.copy())
    out = ck.write_rows_ref(got_t, torch.from_numpy(uniq), torch.from_numpy(new))
    assert out is got_t  # in place
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("width", [1, 20, 21])
def test_writeback_ref_repeated_pad_row_matches_pallas(width):
    """The packer repeats the padding row with identical contents."""
    rng = np.random.default_rng(2 + width)
    table = rng.normal(size=(32, width)).astype(np.float32)
    pad = 31
    rows = np.array([3, pad, 7, pad, pad, pad, pad, pad], np.int32)
    pad_content = rng.normal(size=(width,)).astype(np.float32)
    new = np.stack(
        [np.full(width, 1.0, np.float32), pad_content, np.full(width, 2.0, np.float32)]
        + [pad_content] * 5
    )
    want = np.asarray(
        write_rows_pallas(jnp.asarray(table), jnp.asarray(rows), jnp.asarray(new), interpret=True)
    )
    got = ck.write_rows_ref(
        torch.from_numpy(table.copy()), torch.from_numpy(rows), torch.from_numpy(new)
    ).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[pad], pad_content)


def test_writeback_kernel_refuses_bad_inputs():
    before = ck.launch_counts["write_rows_cuda"]
    with pytest.raises(ValueError, match="CUDA table"):
        ck.write_rows_cuda(
            torch.zeros((4, 3)), torch.zeros(2, dtype=torch.int32), torch.zeros((2, 3))
        )
    assert ck.launch_counts["write_rows_cuda"] == before
    assert set(ck.launch_counts) == {"pull_rows_cuda", "write_rows_cuda"}


def _tile_edges(widths=(1, 4, 21, 128)):
    """(W, U) at and around each width's tile of T rows, U a multiple of 8
    (the TPU kernels take 8 rows a grid step)."""
    cases = []
    for w in widths:
        t = ck.tile_geometry(1, w).tile_rows
        cases += [(w, u) for u in (8, t - 8, t, t + 8, 2 * t + 8)]
    return cases


def _edge_case(width, n_rows):
    """A table, row ids unique but for padding-row repeats at the tail, and
    new rows whose repeats carry identical contents."""
    rng = np.random.default_rng(width * 10_000 + n_rows)
    n_table = 2 * n_rows + 16
    pad = n_table - 1
    table = rng.normal(size=(n_table, width)).astype(np.float32)
    rows = rng.permutation(pad)[:n_rows].astype(np.int32)
    n_pad = max(n_rows // 16, 3)
    rows[-n_pad:] = pad
    new = rng.normal(size=(n_rows, width)).astype(np.float32)
    new[-n_pad:] = new[-1]
    return table, rows, new


@pytest.mark.parametrize("width,n_rows", _tile_edges())
def test_gather_ref_matches_pallas_at_tile_edges(width, n_rows):
    table, rows, _ = _edge_case(width, n_rows)
    rows[::5] = rows[1]  # the gather takes any duplicates
    want = np.asarray(pull_rows_pallas(jnp.asarray(table), jnp.asarray(rows), interpret=True))
    got = ck.pull_rows_ref(torch.from_numpy(table), torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width,n_rows", _tile_edges())
def test_writeback_ref_matches_pallas_at_tile_edges(width, n_rows):
    table, rows, new = _edge_case(width, n_rows)
    want = np.asarray(
        write_rows_pallas(jnp.asarray(table), jnp.asarray(rows), jnp.asarray(new), interpret=True)
    )
    got = ck.write_rows_ref(
        torch.from_numpy(table.copy()), torch.from_numpy(rows), torch.from_numpy(new)
    ).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [1, 4, 21, 128, 1024, 4100])
@pytest.mark.parametrize("n_rows", [0, 1, 5, 191, 192, 193, 1027])
def test_tile_geometry_covers_every_element_once(width, n_rows):
    geo = ck.tile_geometry(n_rows, width)
    t, tc = geo.tile_rows, geo.tile_cols
    assert t % 4 == 0  # every tile of out / new_rows starts 16-byte aligned
    assert t * tc <= ck.TILE_FLOATS
    assert geo.smem_bytes == 8 * t + 4 * t * tc <= ck.MAX_SMEM_BYTES
    assert geo.threads % 32 == 0 and geo.grid_cols <= 65535
    if n_rows == 0:
        assert geo.grid_rows == 0
    assert geo.grid_cols == 1 or t == 4  # only rows past the tile budget are cut
    cover = np.zeros((n_rows, width), np.int32)
    for bx in range(geo.grid_rows):
        for by in range(geo.grid_cols):
            # the block's rows and columns, as the kernels compute them
            n = min(t, n_rows - bx * t)
            cols = min(tc, width - by * tc)
            assert n >= 1 and cols >= 1
            cover[bx * t : bx * t + n, by * tc : by * tc + cols] += 1
    assert (cover == 1).all()


# H100 SXM: 132 SMs, each at most 2048 resident threads and 228 KB of
# shared memory for blocks, of which the runtime keeps 1 KB per block
H100_SMS, SM_THREADS, SM_SMEM, BLOCK_SMEM_RESERVED = 132, 2048, 233_472, 1024


@pytest.mark.parametrize("n_rows", [122_880, 122_624])  # training and serving
def test_tile_geometry_is_one_wave_at_the_flagship_shape(n_rows):
    geo = ck.tile_geometry(n_rows, 21)
    assert geo.tile_rows == 192 and geo.grid_cols == 1
    per_sm = min(
        SM_THREADS // geo.threads, SM_SMEM // (geo.smem_bytes + BLOCK_SMEM_RESERVED)
    )
    assert geo.grid_rows <= H100_SMS * per_sm


@pytest.mark.parametrize("width", [0, 65535 * 1024 + 1])
def test_tile_geometry_refuses_widths_it_cannot_tile(width):
    with pytest.raises(ValueError, match="W="):
        ck.tile_geometry(8, width)


def _table(rng, layout, n):
    table = rng.normal(size=(n, layout.width)).astype(np.float32)
    table[:, layout.SHOW] = rng.integers(0, 100, n).astype(np.float32)
    return table


@pytest.mark.parametrize(
    "feature_type,threshold,scale",
    [
        (FeatureType.PLAIN, 0.0, 1.0),
        (FeatureType.PLAIN, 10.0, 1.0),  # row-level threshold gate
        (FeatureType.VARIABLE, 8.0, 1.0),  # graded per-column unlock
        (FeatureType.PLAIN, 10.0, 0.37),
        (FeatureType.VARIABLE, 5.0, 2.5),
    ],
)
def test_pull_sparse_rows_matches_jax_exactly(feature_type, threshold, scale):
    rng = np.random.default_rng(7)
    lay = ValueLayout(embedx_dim=8, feature_type=feature_type)
    jlay = JValueLayout(embedx_dim=8, feature_type=JFeatureType(feature_type.value))
    table = _table(rng, lay, 96)
    rows = rng.integers(0, 96, 40).astype(np.int32)
    want = np.asarray(
        jpull_sparse_rows(jnp.asarray(table), jnp.asarray(rows), jlay, threshold, scale)
    )
    got = pull_sparse_rows(
        torch.from_numpy(table), torch.from_numpy(rows), lay, threshold, scale
    ).numpy()
    assert got.shape == (40, lay.pull_width)
    np.testing.assert_array_equal(got, want)

