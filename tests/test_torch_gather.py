"""The port's row and lane gathers against the bodies of the two Pallas probes (CPU).

The row gather's index width, which is plain Python, is held to its rule
from shapes alone.

On CPU tensors ``row_gather`` and ``lane_gather`` run their plain versions
(advanced indexing). Both are held against ``jnp.take_along_axis``, the
body of each Pallas kernel (``tools/perf/pallas_gather_probe.py:13``, axis
0; ``tools/perf/pallas_lane_gather_probe.py:16``, axis 1), and against
``np.take_along_axis``, the probes' own oracle, in fp32 and bf16, at probe
shapes cut down in M. A gather moves values and computes nothing, so the
results must be equal. The probe files themselves are not imported: they
run on the TPU when imported.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoframeinterpolation_tpu_torch.kernels import (
    lane_gather, lane_gather_plain, row_gather, row_gather_plain)
from videoframeinterpolation_tpu_torch.kernels.gather import _row_index_bits

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(M, N, dtype, axis, seed):
    """``x (M, N)`` in ``dtype`` and int32 indices in range for ``axis``, as
    numpy arrays (bf16 as ml_dtypes' bfloat16) and as torch tensors."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    x = np.asarray(jnp.asarray(rng.standard_normal((M, N)).astype(np.float32), jdt))
    idx = rng.integers(0, (M, N)[axis], (M, N)).astype(np.int32)
    xt = torch.from_numpy(x.astype(np.float32)).to(tdt)
    return x, idx, xt, torch.from_numpy(idx)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M", [64, 1000])
def test_row_gather_matches_take_along_axis(M, dtype):
    x, idx, xt, it = _inputs(M, 128, dtype, axis=0, seed=M)
    ref_jax = jax.jit(lambda a, i: jnp.take_along_axis(a, i, axis=0))(x, idx)
    ref_np = np.take_along_axis(x, idx, axis=0)
    for out in (row_gather_plain(xt, it), row_gather(xt, it)):
        assert out.dtype == xt.dtype and out.shape == (M, 128)
        np.testing.assert_array_equal(_np(out), np.asarray(ref_jax, np.float32))
        np.testing.assert_array_equal(_np(out), ref_np.astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M", [8, 256])
def test_lane_gather_matches_take_along_axis(M, dtype):
    x, idx, xt, it = _inputs(M, 128, dtype, axis=1, seed=M)
    ref_jax = jax.jit(lambda a, i: jnp.take_along_axis(a, i, axis=1))(x, idx)
    ref_np = np.take_along_axis(x, idx, axis=1)
    for out in (lane_gather_plain(xt, it), lane_gather(xt, it)):
        assert out.dtype == xt.dtype and out.shape == (M, 128)
        np.testing.assert_array_equal(_np(out), np.asarray(ref_jax, np.float32))
        np.testing.assert_array_equal(_np(out), ref_np.astype(np.float32))


def test_gathers_take_index_shapes_as_take_along_axis_does():
    """More index rows than table rows (row gather), fewer index columns
    than table columns (lane gather)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((9, 7)).astype(np.float32)
    rows = rng.integers(0, 9, (13, 7)).astype(np.int32)
    cols = rng.integers(0, 7, (9, 3)).astype(np.int32)
    np.testing.assert_array_equal(row_gather(torch.from_numpy(x), torch.from_numpy(rows)).numpy(),
                                  np.take_along_axis(x, rows, axis=0))
    np.testing.assert_array_equal(lane_gather(torch.from_numpy(x), torch.from_numpy(cols)).numpy(),
                                  np.take_along_axis(x, cols, axis=1))


def test_gathers_on_cpu_count_no_launch():
    _, _, xt, it = _inputs(64, 128, "float32", axis=0, seed=0)
    before = (row_gather.launches, lane_gather.launches)
    row_gather(xt, it)
    lane_gather(xt, it % 128)
    assert (row_gather.launches, lane_gather.launches) == before


@pytest.mark.parametrize("gather", [row_gather, lane_gather])
def test_gathers_reject_what_the_kernels_do_not_take(gather):
    x = torch.randn(16, 8)
    idx = torch.zeros(16, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="2-D"):
        gather(x[None], idx)
    with pytest.raises(ValueError, match="do not match"):
        gather(x, torch.zeros(17, 9, dtype=torch.int32))
    with pytest.raises(ValueError, match="empty"):
        gather(x[:, :0], idx[:, :0])
    with pytest.raises(TypeError, match="table dtype"):
        gather(x.double(), idx)
    with pytest.raises(TypeError, match="index dtype"):
        gather(x, idx.long())
    with pytest.raises(ValueError, match="indices on meta"):
        gather(x, idx.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        gather(x.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError, match="contiguous"):
        gather(x.t().contiguous().t(), idx)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M,N,K,offset", [
    (999, 77, 1004, 0), (1000, 128, 1005, 1), (64, 128, 512, 0), (300, 9, 7, 3)])
def test_row_gather_matches_take_along_axis_at_odd_shapes(M, N, K, offset, dtype):
    """Rows of an odd width, more or fewer index rows than table rows, and
    a table and index at a storage offset (contiguous slices of a larger
    buffer), as the card's checks run them."""
    rng = np.random.default_rng(M + N + K)
    jdt, tdt = DTYPES[dtype]
    x = np.asarray(jnp.asarray(rng.standard_normal((M, N)).astype(np.float32), jdt))
    idx = rng.integers(0, M, (K, N)).astype(np.int32)
    xt = torch.empty(M * N + offset, dtype=tdt)[offset:].view(M, N)
    xt.copy_(torch.from_numpy(x.astype(np.float32)))
    it = torch.empty(K * N + offset, dtype=torch.int32)[offset:].view(K, N)
    it.copy_(torch.from_numpy(idx))
    out = row_gather(xt, it)
    ref_jax = jax.jit(lambda a, i: jnp.take_along_axis(a, i, axis=0))(x, idx)
    assert out.dtype == tdt and out.shape == (K, N)
    np.testing.assert_array_equal(_np(out), np.asarray(ref_jax, np.float32))


@pytest.mark.parametrize("M,N,K,bits", [
    (1024, 128, 1024, 32), (28672, 128, 28672, 32), (1024, 128, 2 ** 24 - 1, 32),
    (1024, 128, 2 ** 24, 64), (2 ** 24 - 1, 128, 10, 32), (2 ** 24, 128, 10, 64),
    (1, 2 ** 31 - 1, 1, 32), (1, 2 ** 31, 1, 64), (3, 715827883, 1, 64),
    (1024, 128, 2 ** 24 + 1, 64)])
def test_row_gather_index_width_is_64_bit_only_from_2_31(M, N, K, bits):
    assert _row_index_bits(M, N, K) == bits
