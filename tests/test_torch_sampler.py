"""The port's deformable sampler and grid_sample against the JAX package (CPU, fp32 and bf16).

Also the CUDA kernel's launch plan, which is plain Python: the vector width
(bytes per load and store) and the index width the wrapper picks per call.

The port's ``deformable_sample`` runs its plain PyTorch version on CPU
tensors. It is held against JAX's ``_grouped_deformable_sample`` (the
function the flagship runs) and against the Pallas
``windowed_deformable_sample`` in interpret mode, on the three cases of
``tests/test_window_sample.py``. Tolerance: 1e-5 max abs in fp32 (the two
compute the same taps in the same order; the Pallas kernel resolves the
taps in window-local coordinates, so it may differ in the last bits).

bf16: the plain version against the JAX model's own sampling step, jitted
(``_grouped_deformable_sample(feat, res + flow, G)`` on bf16 inputs), at the
three DAT level cases: equal element for element. XLA takes the bf16 sum
``res + flow``, which the JAX code then casts to fp32, in fp32; the plain
version does the same, and rounds the tap weights, products and sums to
bf16 where the JAX code does.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoframeinterpolation_tpu.kernels.window_sample import windowed_deformable_sample
from videoframeinterpolation_tpu.nn.deformable_attn import (
    _grouped_deformable_sample as jax_grouped_sample,
)
from videoframeinterpolation_tpu.ops.interp import grid_sample as jax_grid_sample
from videoframeinterpolation_tpu_torch.kernels import deformable_sample, deformable_sample_plain
from videoframeinterpolation_tpu_torch.kernels.window_sample import _index_bits, _vector_bytes
from videoframeinterpolation_tpu_torch.nn.deformable_attn import _grouped_deformable_sample
from videoframeinterpolation_tpu_torch.ops import grid_sample

TOL = 1e-5

# (B2, H, W, G, S, C, offset_scale, flow magnitude, seed): the cases of
# tests/test_window_sample.py, then the flagship's three DAT levels (G=1).
CASES = {
    "interior": (2, 8, 12, 4, 8, 16, 2.0, 3.0, 0),
    "large_flows": (2, 8, 12, 4, 8, 16, 2.0, 20.0, 1),
    "lv2_like": (2, 8, 8, 8, 16, 24, 4.0, 3.0, 2),
    "dat_fast_lv3": (2, 8, 14, 1, 8, 16, 2.0, 3.0, 3),
    "dat_fast_lv2": (2, 16, 28, 1, 8, 16, 4.0, 3.0, 4),
    "dat_fast_lv1": (2, 32, 56, 1, 2, 16, 8.0, 3.0, 5),
}
PALLAS_CASES = ("interior", "large_flows", "lv2_like")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(B2, H, W, G, S, C, sc, flow_mag, seed):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B2, H, W, C)).astype(np.float32)
    flow = (rng.standard_normal((B2, H, W, 2)) * flow_mag).astype(np.float32)
    residual = (rng.uniform(-sc, sc, (B2, H, W, G, S, 2)) * 0.999).astype(np.float32)
    return feat, flow, residual


def _port(feat, flow, residual, G):
    out = deformable_sample(torch.from_numpy(feat), torch.from_numpy(flow),
                            torch.from_numpy(residual), G)
    return out.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_deformable_sample_matches_jax_grouped_sampler(name):
    B2, H, W, G, S, C, sc, mag, seed = CASES[name]
    feat, flow, residual = _case(*CASES[name])
    ref = jax.jit(jax_grouped_sample, static_argnums=2)(
        feat, residual + flow[:, :, :, None, None, :], G)
    out = _port(feat, flow, residual, G)
    assert out.shape == (B2, S, H * W, C)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["dat_fast_lv3", "dat_fast_lv2", "dat_fast_lv1"])
def test_deformable_sample_matches_the_jax_model_step_in_bf16(name):
    B2, H, W, G, S, C, sc, mag, seed = CASES[name]
    feat, flow, residual = (jnp.asarray(a, jnp.bfloat16) for a in _case(*CASES[name]))
    ref = jax.jit(lambda f, fl, r: jax_grouped_sample(f, r + fl[:, :, :, None, None, :], G))(
        feat, flow, residual)
    out = deformable_sample(*(torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16()
                              for a in (feat, flow, residual)), G)
    assert out.dtype == torch.bfloat16 and out.shape == (B2, S, H * W, C)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_deformable_sample_matches_pallas_kernel(name):
    B2, H, W, G, S, C, sc, mag, seed = CASES[name]
    feat, flow, residual = _case(*CASES[name])
    ref = windowed_deformable_sample(jnp.asarray(feat), jnp.asarray(flow),
                                     jnp.asarray(residual), G, sc, interpret=True)
    out = _port(feat, flow, residual, G)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=TOL)


def test_grouped_sampler_of_the_attention_module_matches_jax():
    feat, flow, residual = _case(*CASES["interior"])
    off = residual + flow[:, :, :, None, None, :]
    ref = jax_grouped_sample(jnp.asarray(feat), jnp.asarray(off), 4)
    out = _grouped_deformable_sample(torch.from_numpy(feat), torch.from_numpy(off), 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def _edge_coords(B, H, W, n, seed):
    """Sample positions on integers, on the last row and column, negative,
    just outside and far outside the frame, plus random ones."""
    rng = np.random.default_rng(seed)
    special = np.array([[0, 0], [W - 1, H - 1], [W - 1, 0.5], [0.25, H - 1],
                        [-0.5, 2], [-1, -1], [W - 0.5, H - 0.5], [W, H],
                        [3, 2], [-1e4, 5], [1e4, -1e4], [2.5, -0.999]], np.float32)
    rand = rng.uniform(-3, max(H, W) + 3, (B, n, 2)).astype(np.float32)
    return np.concatenate([np.broadcast_to(special, (B,) + special.shape), rand], axis=1)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_grid_sample_matches_jax(mode):
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, 9, 13, 5)).astype(np.float32)
    coords = _edge_coords(2, 9, 13, 40, seed=8).reshape(2, 4, 13, 2)
    ref = jax_grid_sample(jnp.asarray(img), jnp.asarray(coords), padding_mode=mode)
    out = grid_sample(torch.from_numpy(img), torch.from_numpy(coords), padding_mode=mode)
    assert out.shape == (2, 4, 13, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_deformable_sample_on_cpu_counts_no_launch():
    feat, flow, residual = _case(*CASES["dat_fast_lv3"])
    before = deformable_sample.launches
    out = _port(feat, flow, residual, 1)
    plain = deformable_sample_plain(torch.from_numpy(feat), torch.from_numpy(flow),
                                    torch.from_numpy(residual), 1)
    assert deformable_sample.launches == before
    np.testing.assert_array_equal(out, plain.numpy())


def test_deformable_sample_rejects_what_the_kernel_does_not_take():
    feat, flow, residual = (torch.from_numpy(a) for a in _case(*CASES["interior"]))
    with pytest.raises(ValueError, match="groups"):
        deformable_sample(feat, flow, residual[:, :, :, :3], 3)     # 3 does not divide 16
    with pytest.raises(ValueError, match="does not match"):
        deformable_sample(feat, flow[:, :-1], residual, 4)
    with pytest.raises(ValueError, match="does not match"):
        deformable_sample(feat, flow, residual, 2)
    with pytest.raises(TypeError, match="dtype"):
        deformable_sample(feat.double(), flow.double(), residual.double(), 4)
    with pytest.raises(TypeError, match="dtype"):
        deformable_sample(feat, flow.bfloat16(), residual, 4)
    with pytest.raises(ValueError, match="contiguous"):
        deformable_sample(feat.transpose(1, 2).contiguous().transpose(1, 2), flow, residual, 4)
    with pytest.raises(ValueError, match="expected"):
        deformable_sample(feat[0], flow, residual, 4)


# (C, G, element size, data pointers of feat and out, expected bytes per load):
# the DAT levels' widths, then group widths and storage offsets that force
# a narrower vector.
VECTOR_CASES = {
    "shared_bf16": (72, 1, 2, (0, 0), 16),
    "shared_fp32": (72, 1, 4, (0, 0), 16),
    "cg18_bf16": (72, 4, 2, (0, 0), 4),      # 36 bytes a group
    "cg18_fp32": (72, 4, 4, (0, 0), 8),      # 72 bytes
    "cg9_bf16": (72, 8, 2, (0, 0), 2),       # 18 bytes
    "cg9_fp32": (72, 8, 4, (0, 0), 4),
    "c40_g1_bf16": (40, 1, 2, (0, 0), 16),
    "odd_cg7_bf16": (21, 3, 2, (0, 0), 2),
    "odd_cg7_fp32": (21, 3, 4, (0, 0), 4),
    "cg1_bf16": (8, 8, 2, (0, 0), 2),
    "feat_offset_1_bf16": (72, 1, 2, (4096 + 2, 0), 2),
    "feat_offset_2_bf16": (72, 1, 2, (4096 + 4, 0), 4),
    "feat_offset_4_bf16": (72, 1, 2, (4096 + 8, 0), 8),
    "feat_offset_1_fp32": (72, 1, 4, (4096 + 4, 0), 4),
    "feat_offset_2_fp32": (72, 1, 4, (4096 + 8, 0), 8),
    "out_offset_fp32": (72, 1, 4, (0, 4096 + 8), 8),
    "offset_and_narrow_group_fp32": (72, 4, 4, (4096 + 4, 0), 4),
}


@pytest.mark.parametrize("name", sorted(VECTOR_CASES))
def test_vector_width_divides_the_group_and_every_pointer(name):
    C, G, esize, ptrs, expected = VECTOR_CASES[name]
    width = _vector_bytes(C, G, esize, *ptrs)
    assert width == expected
    assert width >= esize and (C // G * esize) % width == 0
    assert all(p % width == 0 for p in ptrs)


# (B2, H, W, C, G, S, expected index bits), from shapes only: nothing is
# allocated.
INDEX_CASES = {
    "dat_fast_lv1_448x256": (2, 128, 224, 72, 1, 2, 32),
    "dat_lv1_448x256": (2, 128, 224, 72, 8, 32, 32),
    "dat_fast_lv1_1080p": (2, 544, 960, 72, 1, 2, 32),
    "dat_fast_lv1_4k": (2, 1088, 1920, 72, 1, 2, 32),
    "dat_lv1_1080p": (2, 544, 960, 72, 8, 32, 64),           # 2.4e9 output elements
    "out_just_below_2_31": (1, 1, 1, 2 ** 31 // 128 - 1, 1, 128, 32),
    "out_at_2_31": (1, 1, 1, 2 ** 31 // 128, 1, 128, 64),
    "residual_larger_than_out": (1, 1024, 1024, 8, 8, 128, 64),   # 2G*S*HW = 2^31
}


@pytest.mark.parametrize("name", sorted(INDEX_CASES))
def test_index_width_is_64_bit_only_where_an_index_reaches_2_31(name):
    B2, H, W, C, G, S, expected = INDEX_CASES[name]
    largest = max(B2 * S * H * W * C, B2 * H * W * G * S * 2)
    assert _index_bits(B2, H, W, C, G, S) == expected
    assert (expected == 32) == (largest < 2 ** 31)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_deformable_sample_takes_a_feature_map_at_a_storage_offset(offset):
    feat, flow, residual = (torch.from_numpy(a) for a in _case(*CASES["dat_fast_lv3"]))
    buf = torch.zeros(feat.numel() + offset)
    shifted = buf[offset:].view(feat.shape)
    shifted.copy_(feat)
    assert shifted.is_contiguous() and shifted.storage_offset() == offset
    out = deformable_sample(shifted, flow, residual, 1)
    np.testing.assert_array_equal(out.numpy(), deformable_sample(feat, flow, residual, 1).numpy())
