"""The port's CUDA kernels against their plain versions, on the card.

``chip_smoke.py`` holds the kernels against their plain versions at the
shapes of the serving path and of the gather probes; these tests hold the
sampler at the DAT level shapes of the three checkpoints (a 448x256
request and a held-out evaluation batch of each), at narrow and odd
group widths, at a storage offset, at every vector width and both index
widths, and add odd sizes for the gathers (a table height that is no
multiple of 32), the row gather at both index widths (a misaligned table
and index, more index rows than table rows) and its refusal of an index
width the call does not fit, and one counted launch per call; and
``multi_t_apply`` on the card, whose frames equal the per-instant
forward's bit for bit.

These tests need an NVIDIA card with nvcc (the kernels have no CPU mode) and
skip without one. On the card's machine, which has no JAX, run them without
the JAX test configuration::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from videoframeinterpolation_tpu_torch.kernels import (
    deformable_sample, lane_gather, lane_gather_plain, row_gather, row_gather_plain)
from videoframeinterpolation_tpu_torch.kernels.gather import _row_gather_launch
from videoframeinterpolation_tpu_torch.kernels.window_sample import (
    _grouped_deformable_sample, _index_bits, _launch, _vector_bytes)

pytestmark = pytest.mark.cuda

# (B2, H, W, C, G, S, residual scale, storage offset of feat in elements):
# an odd shape with large residuals, the DAT levels of a 448x256 request
# (shared offsets, then configs/DAT.yaml's non-shared ones), narrow and odd
# group widths, and feat misaligned by a storage offset.
SAMPLER_CASES = {
    "odd_9x13_c40_g8": (1, 9, 13, 40, 8, 3, 30.0, 0),
    "shared_lv3": (2, 32, 56, 72, 1, 8, 2.0, 0),
    "shared_lv2": (2, 64, 112, 72, 1, 8, 4.0, 0),
    "shared_lv1": (2, 128, 224, 72, 1, 2, 8.0, 0),
    "non_shared_lv3": (2, 32, 56, 72, 4, 8, 2.0, 0),
    "non_shared_lv2": (2, 64, 112, 72, 8, 16, 4.0, 0),
    "non_shared_lv1": (2, 128, 224, 72, 8, 32, 8.0, 0),
    "cg9": (1, 9, 13, 72, 8, 3, 30.0, 0),
    "cg18": (2, 11, 17, 72, 4, 5, 3.0, 0),
    "c40_g1": (1, 9, 13, 40, 1, 3, 30.0, 0),
    "odd_cg7": (2, 11, 17, 21, 3, 5, 3.0, 0),
    "misaligned_by_1": (2, 32, 56, 72, 1, 8, 2.0, 1),
    "misaligned_by_2": (2, 32, 56, 72, 1, 8, 2.0, 2),
    # The teacher's levels of a 448x256 request (G 1, S 8/16/8; its lv3 is
    # shared_lv3), and the levels of a held-out evaluation batch (8 pairs of
    # 128x128, B2 16) of each configuration (the teacher's lv3 is
    # eval_shared_lv3).
    "teacher_lv2": (2, 64, 112, 72, 1, 16, 4.0, 0),
    "teacher_lv1": (2, 128, 224, 72, 1, 8, 8.0, 0),
    "eval_shared_lv3": (16, 16, 16, 72, 1, 8, 2.0, 0),
    "eval_shared_lv2": (16, 32, 32, 72, 1, 8, 4.0, 0),
    "eval_shared_lv1": (16, 64, 64, 72, 1, 2, 8.0, 0),
    "eval_non_shared_lv3": (16, 16, 16, 72, 4, 8, 2.0, 0),
    "eval_non_shared_lv2": (16, 32, 32, 72, 8, 16, 4.0, 0),
    "eval_non_shared_lv1": (16, 64, 64, 72, 8, 32, 8.0, 0),
    "eval_teacher_lv2": (16, 32, 32, 72, 1, 16, 4.0, 0),
    "eval_teacher_lv1": (16, 64, 64, 72, 1, 8, 8.0, 0),
}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, B2, H, W, C, G, S, scale, flow_mag=4.0):
    feat = torch.randn((B2, H, W, C), generator=gen, device="cuda")
    flow = torch.randn((B2, H, W, 2), generator=gen, device="cuda") * flow_mag
    res = scale * torch.tanh(torch.randn((B2, H, W, G, S, 2), generator=gen, device="cuda"))
    return feat, flow, res


def _at_offset(x, offset):
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def _reference(feat, flow, res):
    """The plain version's fp32 sampling of the inputs, rounded once to
    their dtype: the plain version itself in fp32, and in bf16 what the
    kernel computes (fp32 taps, one rounding)."""
    ref = _grouped_deformable_sample(
        feat.float(), res.float() + flow.float()[:, :, :, None, None, :], res.shape[3])
    return ref.to(feat.dtype)


def _case(gen, name, dtype):
    B2, H, W, C, G, S, scale, offset = SAMPLER_CASES[name]
    feat, flow, res = (x.to(dtype) for x in _inputs(gen, B2, H, W, C, G, S, scale))
    return _at_offset(feat, offset), flow, res


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SAMPLER_CASES))
def test_kernel_matches_plain_version(gen, name, dtype):
    feat, flow, res = _case(gen, name, dtype)
    out = deformable_sample(feat, flow, res, res.shape[3])
    torch.cuda.synchronize()
    # Equal: same taps in the same order, products and sums without FMA,
    # one rounding in bf16.
    assert (out.float() - _reference(feat, flow, res).float()).abs().max().item() == 0.0


@pytest.mark.parametrize("index_bits", [32, 64])
@pytest.mark.parametrize("dtype,vector_bytes", [
    (torch.float32, 16), (torch.float32, 8), (torch.float32, 4),
    (torch.bfloat16, 16), (torch.bfloat16, 8), (torch.bfloat16, 4), (torch.bfloat16, 2)])
def test_every_vector_and_index_width_matches_plain_version(gen, dtype, vector_bytes, index_bits):
    feat, flow, res = _case(gen, "shared_lv3", dtype)
    out = _launch(feat, flow, res, 1, vector_bytes, index_bits)
    torch.cuda.synchronize()
    assert (out.float() - _reference(feat, flow, res).float()).abs().max().item() == 0.0


def test_a_width_the_call_does_not_fit_is_refused(gen):
    feat, flow, res = _case(gen, "misaligned_by_1", torch.float32)
    assert _vector_bytes(72, 1, 4, feat.data_ptr()) == 4
    with pytest.raises(RuntimeError, match="failed to launch"):
        _launch(feat, flow, res, 1, 16, 32)
    feat, flow, res = _case(gen, "cg9", torch.bfloat16)
    with pytest.raises(RuntimeError, match="failed to launch"):
        _launch(feat, flow, res, 8, 4, 32)


def test_an_output_of_2_31_elements_takes_64_bit_indices(gen):
    """The non-shared lv1 of a 1080p request: 2.4e9 output elements (4.8 GB in bf16)."""
    B2, H, W, C, G, S = 2, 544, 960, 72, 8, 32
    assert _index_bits(B2, H, W, C, G, S) == 64
    feat, flow, res = (x.bfloat16() for x in _inputs(gen, B2, H, W, C, G, S, 8.0))
    out = deformable_sample(feat, flow, res, G)
    torch.cuda.synchronize()
    for b, s in ((0, 0), (B2 - 1, S - 1)):
        ref = _reference(feat[b:b + 1], flow[b:b + 1], res[b:b + 1, :, :, :, s:s + 1])
        assert torch.equal(out[b:b + 1, s:s + 1], ref)


def test_each_call_is_one_counted_launch(gen):
    feat, flow, res = _inputs(gen, 2, 8, 8, 16, 1, 4, 2.0)
    before, before_bf16 = deformable_sample.launches, deformable_sample.bf16_launches
    deformable_sample(feat, flow, res, 1)
    deformable_sample(feat.bfloat16(), flow.bfloat16(), res.bfloat16(), 1)
    assert deformable_sample.launches == before + 2
    assert deformable_sample.bf16_launches == before_bf16 + 1


# name -> (M, N, K, storage offset of x and idx, index bits or None for the
# wrapper's own width).
ROW_GATHER_CASES = {
    "wrapper_1001x77": (1001, 77, 45, 0, None),
    "wrapper_k8m": (1024, 128, 8192, 0, None),
    "offset1": (1000, 128, 999, 1, None),
    "bits_32": (300, 77, 301, 0, 32),
    "bits_64": (300, 77, 301, 0, 64),
    "offset1_64_bit": (1000, 128, 999, 1, 64),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(ROW_GATHER_CASES))
def test_row_gather_matches_plain_version(gen, case, dtype):
    M, N, K, offset, bits = ROW_GATHER_CASES[case]
    x = _at_offset(torch.randn((M, N), generator=gen, device="cuda").to(dtype), offset)
    idx = _at_offset(torch.randint(0, M, (K, N), generator=gen, device="cuda",
                                   dtype=torch.int32), offset)
    before = row_gather.launches
    out = row_gather(x, idx) if bits is None else _row_gather_launch(x, idx, bits)
    torch.cuda.synchronize()
    assert torch.equal(out, row_gather_plain(x, idx))
    assert row_gather.launches == before + 1


def test_a_row_gather_index_width_the_call_does_not_fit_is_refused(gen):
    x = torch.randn((1000, 128), generator=gen, device="cuda")
    idx = torch.randint(0, 1000, (1000, 128), generator=gen, device="cuda", dtype=torch.int32)
    before = row_gather.launches
    for bits in (0, 16, 48):
        with pytest.raises(RuntimeError, match="failed to launch"):
            _row_gather_launch(x, idx, bits)
    assert row_gather.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_gather_matches_plain_version(gen, dtype):
    x = torch.randn((1001, 77), generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, 77, (1001, 45), generator=gen, device="cuda", dtype=torch.int32)
    before = lane_gather.launches
    out = lane_gather(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, lane_gather_plain(x, idx))
    assert lane_gather.launches == before + 1


def test_multi_t_apply_equals_the_per_instant_forward_on_the_card(gen):
    from videoframeinterpolation_tpu_torch.config import DAT_fast
    from videoframeinterpolation_tpu_torch.interpolate import SHIPPED_STUDENT, load_model
    from videoframeinterpolation_tpu_torch.models import multi_t_apply

    model = load_model(DAT_fast, SHIPPED_STUDENT, device="cuda")
    x0 = torch.rand((1, 64, 96, 3), generator=gen, device="cuda")
    x1 = torch.roll(x0, (2, 3), dims=(1, 2))
    ts = (0.25, 0.5, 0.75)
    with torch.inference_mode():
        before = deformable_sample.bf16_launches
        frames = multi_t_apply(model, x0, x1, ts)
        assert deformable_sample.bf16_launches == before + 3 * len(ts)
        for k, t in enumerate(ts):
            assert torch.equal(frames[k], model(x0, x1, torch.full((1, 1, 1, 1), t,
                                                                   device="cuda")))
