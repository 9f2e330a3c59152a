"""The port's CUDA kernels against their plain versions, on the card.

``chip_smoke.py`` holds the kernels against their plain versions at the
shapes of the serving path and of the gather probes; these tests hold the
sampler at the DAT level shapes of the three checkpoints (a 448x256
request and a held-out evaluation batch of each) and of DCNDAT's 448x256
request (C 64, G 8/4/4, S 9), at narrow and odd
group widths, at a storage offset, at every vector width and both index
widths, and add odd sizes for the gathers (a table height that is no
multiple of 32), the row gather at both index widths (a misaligned table
and index, more index rows than table rows) and its refusal of an index
width the call does not fit, and one counted launch per call; and
``multi_t_apply`` on the card, whose frames equal the per-instant
forward's bit for bit; and the sampler's backward kernel against autograd
through the plain version, at the student's and the teacher's level shapes
of a training batch, DCNDAT's at its recipe (B2 24), and at edge cases
(far outside, integer coordinates, every sample of every query on one
pixel, odd group widths), in fp32
(each gradient within 1e-5 of its max abs: fp32 sums in another order,
atomics in a changing order) and in bf16 (at most 1 bf16 ulp from the fp32
gradient of the bf16 inputs, rounded once; where those fp32 sums cancel,
so that the two orders differ by more than an ulp of the small result,
within the fp32 limit instead), at every vector and index width, with one
counted backward launch per call of the autograd Function; the global
backward path, forced, beside the planned shared-memory path at the
student's, the teacher's and DCNDAT's training levels and at the edge
cases, with
``grad_residual`` and ``grad_flow`` equal bit for bit over two launches
(they are summed without atomics; ``grad_feat``, summed with atomics, is
held to the tolerance only), the refusal of a plan that does not fit the
call with no launch counted, and a forward and backward through
``DeformableSample`` captured in a CUDA graph; and the sampler and its
backward on a query grid of stride 2 (the ``attn_stride`` variant's level
1) at its served and training shapes, at a non-shared shape and with taps
past every border, held as above, with the refusal of a stride that does
not divide the features.

These tests need an NVIDIA card with nvcc (the kernels have no CPU mode) and
skip without one. On the card's machine, which has no JAX, run them without
the JAX test configuration::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from videoframeinterpolation_tpu_torch.kernels import (
    build, deformable_sample, deformable_sample_backward_plain, lane_gather, lane_gather_plain,
    row_gather, row_gather_plain)
from videoframeinterpolation_tpu_torch.kernels.gather import _row_gather_launch
from videoframeinterpolation_tpu_torch.kernels.window_sample import (
    BackwardPlan, DeformableSample, _backward_plan, _grouped_deformable_sample, _index_bits,
    _launch, _launch_backward, _vector_bytes)

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
    # DCNDAT's levels of a 448x256 request (nf 64, G 8/4/4, S 9, offset
    # scale 2: 8 and 16 channels per group).
    "dcndat_lv3": (2, 32, 56, 64, 8, 9, 2.0, 0),
    "dcndat_lv2": (2, 64, 112, 64, 4, 9, 2.0, 0),
    "dcndat_lv1": (2, 128, 224, 64, 4, 9, 2.0, 0),
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


# (B2, H, W, C, G, S, residual scale, flow magnitude): the levels of a
# training batch (8 pairs of 128x128, B2 16) of the student (S 8/8/2) and
# the teacher (S 8/16/8; its lv3 is the student's), DCNDAT's at its recipe
# (12 pairs of 256x256, B2 24), and edge cases.
BACKWARD_CASES = {
    "train_student_lv3": (16, 16, 16, 72, 1, 8, 2.0, 4.0),
    "train_student_lv2": (16, 32, 32, 72, 1, 8, 4.0, 4.0),
    "train_student_lv1": (16, 64, 64, 72, 1, 2, 8.0, 4.0),
    "train_teacher_lv2": (16, 32, 32, 72, 1, 16, 4.0, 4.0),
    "train_teacher_lv1": (16, 64, 64, 72, 1, 8, 8.0, 4.0),
    "train_dcndat_lv3": (24, 32, 32, 64, 8, 9, 2.0, 4.0),
    "train_dcndat_lv2": (24, 64, 64, 64, 4, 9, 2.0, 4.0),
    "train_dcndat_lv1": (24, 128, 128, 64, 4, 9, 2.0, 4.0),
    "far_outside": (2, 9, 13, 40, 8, 3, 30.0, 1e4),
    "cg9": (1, 9, 13, 72, 8, 3, 30.0, 4.0),
    "odd_cg7": (2, 11, 17, 21, 3, 5, 3.0, 4.0),
    "integer": (2, 16, 16, 72, 1, 8, 2.0, 3.0),
    "one_pixel": (2, 16, 16, 16, 1, 8, 0.0, 0.0),
}
BWD_FP32_TOL = 1e-5


def _backward_case(gen, name, dtype):
    """``feat, flow, residual, grad_out`` of a case, in ``dtype``."""
    B2, H, W, C, G, S, scale, flow_mag = BACKWARD_CASES[name]
    feat, flow, res = _inputs(gen, B2, H, W, C, G, S, scale, flow_mag)
    if name == "integer":
        flow, res = torch.round(flow), torch.round(res)
    if name == "one_pixel":   # every sample of every query at (3.25, 2.5)
        gy, gx = torch.meshgrid(torch.arange(H, device="cuda", dtype=torch.float32),
                                torch.arange(W, device="cuda", dtype=torch.float32),
                                indexing="ij")
        flow = torch.stack([3.25 - gx, 2.5 - gy], -1).expand(B2, H, W, 2).contiguous()
    grad_out = torch.randn((B2, S, H * W, C), generator=gen, device="cuda")
    return tuple(x.to(dtype).contiguous() for x in (feat, flow, res, grad_out))


def _bf16_close(out, ref):
    """Each element within 1 bf16 ulp, or within the fp32 limit of the max abs."""
    mag = torch.maximum(out.abs(), ref.abs())
    _, exp = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), exp - 8).clamp_min(2.0 ** -133)
    diff = (out - ref).abs()
    return bool(((diff <= ulp) | (diff <= BWD_FP32_TOL * ref.abs().max())).all())


def _check_backward(got, feat, flow, res, grad_out):
    ref = deformable_sample_backward_plain(feat, flow, res, grad_out, res.shape[3])
    for g, r, name in zip(got, ref, ("feat", "flow", "residual")):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if g.dtype == torch.float32:
            err = (g - r).abs().max().item()
            assert err <= BWD_FP32_TOL * r.abs().max().item(), (name, err)
        else:
            assert _bf16_close(g.float(), r.float()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(BACKWARD_CASES))
def test_backward_kernel_matches_autograd_through_the_plain_version(gen, name, dtype):
    feat, flow, res, grad_out = _backward_case(gen, name, dtype)
    got = _launch_backward(feat, flow, res, grad_out, res.shape[3])
    torch.cuda.synchronize()
    _check_backward(got, feat, flow, res, grad_out)


@pytest.mark.parametrize("index_bits", [32, 64])
@pytest.mark.parametrize("dtype,vector_bytes", [
    (torch.float32, 16), (torch.float32, 8), (torch.float32, 4),
    (torch.bfloat16, 16), (torch.bfloat16, 8), (torch.bfloat16, 4), (torch.bfloat16, 2)])
def test_every_backward_vector_and_index_width_matches(gen, dtype, vector_bytes, index_bits):
    feat, flow, res, grad_out = _backward_case(gen, "train_student_lv3", dtype)
    got = _launch_backward(feat, flow, res, grad_out, 1, vector_bytes, index_bits)
    torch.cuda.synchronize()
    _check_backward(got, feat, flow, res, grad_out)


def test_a_backward_width_the_call_does_not_fit_is_refused(gen):
    feat, flow, res, grad_out = _backward_case(gen, "cg9", torch.bfloat16)
    before = deformable_sample.backward_launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        _launch_backward(feat, flow, res, grad_out, 8, 4, 32)
    assert deformable_sample.backward_launches == before


def test_autograd_on_the_card_runs_the_backward_kernel_once(gen):
    """``deformable_sample`` on CUDA tensors that need a gradient: one
    forward and one backward launch, and the backward kernel's gradients."""
    feat, flow, res, grad_out = _backward_case(gen, "train_student_lv2", torch.bfloat16)
    leaves = [x.detach().requires_grad_() for x in (feat, flow, res)]
    before = (deformable_sample.launches, deformable_sample.backward_launches)
    out = deformable_sample(*leaves, 1)
    out.backward(grad_out)
    torch.cuda.synchronize()
    assert (deformable_sample.launches, deformable_sample.backward_launches) == (
        before[0] + 1, before[1] + 1)
    _check_backward([x.grad for x in leaves], feat, flow, res, grad_out)


# The cases of both backward paths: the training levels, then edge cases.
PATH_CASES = ["train_student_lv3", "train_student_lv2", "train_student_lv1",
              "train_teacher_lv2", "train_teacher_lv1", "one_pixel", "cg9", "odd_cg7",
              "train_dcndat_lv3", "train_dcndat_lv2", "train_dcndat_lv1"]


def _plan(name, dtype, path):
    """The planned path of a case (shared memory at every case here), or the
    global path forced at the same index width."""
    B2, H, W, C, G, S = BACKWARD_CASES[name][:6]
    plan = _backward_plan(B2, H, W, C, G, S)
    assert plan.path == "smem", plan
    return plan if path == "smem" else BackwardPlan("global", 0, 0, plan.index_bits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", PATH_CASES)
def test_the_global_backward_path_matches_autograd_through_the_plain_version(gen, name, dtype):
    """The global path forced where the shared-memory path is planned (the
    planned path at these cases is the test above)."""
    feat, flow, res, grad_out = _backward_case(gen, name, dtype)
    before = dict(deformable_sample.backward_path_launches)
    got = _launch_backward(feat, flow, res, grad_out, res.shape[3],
                           plan=_plan(name, dtype, "global"))
    torch.cuda.synchronize()
    assert deformable_sample.backward_path_launches == {**before,
                                                        "global": before["global"] + 1}
    _check_backward(got, feat, flow, res, grad_out)


@pytest.mark.parametrize("path", ["smem", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", PATH_CASES[:5])
def test_coordinate_gradients_are_reproducible(gen, name, dtype, path):
    """``grad_residual`` and ``grad_flow`` are summed in a fixed order
    without atomics: two launches give the same bits on either path."""
    feat, flow, res, grad_out = _backward_case(gen, name, dtype)
    plan = _plan(name, dtype, path)
    first = _launch_backward(feat, flow, res, grad_out, res.shape[3], plan=plan)
    second = _launch_backward(feat, flow, res, grad_out, res.shape[3], plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


@pytest.mark.parametrize("plan", [
    BackwardPlan("smem", 2, 0, 32),            # 2 does not divide a group of 9 channels
    BackwardPlan("smem", 0, 0, 32),
    BackwardPlan("shared", 9, 0, 32)])
def test_a_backward_plan_that_does_not_fit_is_refused(gen, plan):
    feat, flow, res, grad_out = _backward_case(gen, "cg9", torch.bfloat16)
    before = (deformable_sample.backward_launches, dict(deformable_sample.backward_path_launches))
    with pytest.raises(RuntimeError, match="failed to launch"):
        _launch_backward(feat, flow, res, grad_out, 8, plan=plan)
    assert (deformable_sample.backward_launches,
            dict(deformable_sample.backward_path_launches)) == before


def test_a_slice_beyond_227_kb_is_refused(gen):
    """At a 448x256 request's lv1 one channel takes 112 KB, so three take
    336 KB: more than a block may hold."""
    feat, flow, res = _inputs(gen, 1, 128, 224, 72, 1, 1, 8.0)
    grad_out = torch.randn((1, 1, 128 * 224, 72), generator=gen, device="cuda")
    before = deformable_sample.backward_launches
    with pytest.raises(RuntimeError, match="failed to launch"):
        _launch_backward(feat, flow, res, grad_out, 1, plan=BackwardPlan("smem", 3, 0, 32))
    assert deformable_sample.backward_launches == before


def test_the_build_figures_are_the_cards(gen):
    """The figures the kernels are compiled with and the backward's plan
    reads (``kernels/build.py``) are the card's, where this PyTorch's device
    properties carry them."""
    props = torch.cuda.get_device_properties(0)
    assert props.multi_processor_count == build.SMS
    for name, value in (("max_threads_per_multi_processor", build.THREADS_PER_SM),
                        ("shared_memory_per_multiprocessor", build.SMEM_PER_SM),
                        ("shared_memory_per_block_optin", build.SMEM_PER_BLOCK)):
        assert getattr(props, name, value) == value, name


def test_the_backward_runs_under_cuda_graph_capture(gen):
    """A forward and backward through ``DeformableSample`` captured in one
    CUDA graph: on replay, the coordinate gradients equal an eager call's
    bit for bit and ``grad_feat`` is within the tolerance of the plain
    version; the replay adds no launch to the counts."""
    feat, flow, res, grad_out = _backward_case(gen, "train_student_lv2", torch.bfloat16)
    leaves = [x.detach().clone().requires_grad_() for x in (feat, flow, res)]

    def step():
        for x in leaves:
            x.grad = None
        DeformableSample.apply(*leaves, 1, 1).backward(grad_out)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    for x in leaves:
        x.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        DeformableSample.apply(*leaves, 1, 1).backward(grad_out)
    counts = (deformable_sample.launches, deformable_sample.backward_launches)
    graph.replay()
    torch.cuda.synchronize()
    assert (deformable_sample.launches, deformable_sample.backward_launches) == counts
    eager = _launch_backward(feat, flow, res, grad_out, 1)
    torch.cuda.synchronize()
    assert torch.equal(leaves[1].grad, eager[1]) and torch.equal(leaves[2].grad, eager[2])
    _check_backward([x.grad for x in leaves], feat, flow, res, grad_out)


# The query grid of stride 2 (the attn_stride variant's level 1): (B2, H, W,
# C, G, S, residual scale, flow magnitude) with (H, W) the feature grid: a
# 448x256 request (B2 2), a training batch of 8 pairs of 128x128 (B2 16), a
# non-shared shape (G 8, 9 channels each) and one whose taps fall past every
# border.
STRIDED_CASES = {
    "served_lv1": (2, 128, 224, 72, 1, 16, 8.0, 4.0),
    "train_lv1": (16, 64, 64, 72, 1, 16, 8.0, 4.0),
    "non_shared": (2, 16, 24, 72, 8, 4, 8.0, 4.0),
    "past_borders": (2, 10, 14, 40, 8, 3, 30.0, 20.0),
}


def _strided_case(gen, name, dtype):
    B2, H, W, C, G, S, scale, flow_mag = STRIDED_CASES[name]
    feat = torch.randn((B2, H, W, C), generator=gen, device="cuda")
    flow = torch.randn((B2, H // 2, W // 2, 2), generator=gen, device="cuda") * flow_mag
    res = scale * torch.tanh(torch.randn((B2, H // 2, W // 2, G, S, 2), generator=gen,
                                         device="cuda"))
    grad_out = torch.randn((B2, S, H * W // 4, C), generator=gen, device="cuda")
    return tuple(x.to(dtype).contiguous() for x in (feat, flow, res, grad_out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(STRIDED_CASES))
def test_strided_kernel_matches_plain_version(gen, name, dtype):
    feat, flow, res, _ = _strided_case(gen, name, dtype)
    before = deformable_sample.launches
    out = deformable_sample(feat, flow, res, res.shape[3], stride=2)
    torch.cuda.synchronize()
    assert deformable_sample.launches == before + 1
    ref = _grouped_deformable_sample(
        feat.float(), res.float() + flow.float()[:, :, :, None, None, :], res.shape[3], 2)
    assert (out.float() - ref.to(feat.dtype).float()).abs().max().item() == 0.0


@pytest.mark.parametrize("path", ["smem", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(STRIDED_CASES))
def test_strided_backward_matches_autograd_through_the_plain_version(gen, name, dtype, path):
    feat, flow, res, grad_out = _strided_case(gen, name, dtype)
    G = res.shape[3]
    plan = _backward_plan(*feat.shape, G, res.shape[4], 2)
    if path == "global":
        plan = BackwardPlan("global", 0, 0, plan.index_bits)
    got = _launch_backward(feat, flow, res, grad_out, G, plan=plan, stride=2)
    again = _launch_backward(feat, flow, res, grad_out, G, plan=plan, stride=2)
    torch.cuda.synchronize()
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    ref = deformable_sample_backward_plain(feat, flow, res, grad_out, G, 2)
    for g, r, which in zip(got, ref, ("feat", "flow", "residual")):
        assert g.dtype == r.dtype and g.shape == r.shape, which
        if g.dtype == torch.float32:
            err = (g - r).abs().max().item()
            assert err <= BWD_FP32_TOL * r.abs().max().item(), (which, err)
        else:
            assert _bf16_close(g.float(), r.float()), which


def test_autograd_on_a_strided_grid_runs_both_kernels_once(gen):
    feat, flow, res, grad_out = _strided_case(gen, "train_lv1", torch.bfloat16)
    leaves = [x.detach().requires_grad_() for x in (feat, flow, res)]
    before = (deformable_sample.launches, deformable_sample.backward_launches)
    deformable_sample(*leaves, 1, stride=2).backward(grad_out)
    torch.cuda.synchronize()
    assert (deformable_sample.launches, deformable_sample.backward_launches) == (
        before[0] + 1, before[1] + 1)


def test_a_stride_that_does_not_divide_the_features_is_refused(gen):
    feat, flow, res, grad_out = _strided_case(gen, "past_borders", torch.float32)
    with pytest.raises(ValueError, match="stride"):
        deformable_sample(feat, flow, res, 8, stride=3)
    before = (deformable_sample.launches, deformable_sample.backward_launches)
    odd = feat[:, :9].contiguous()
    with pytest.raises(RuntimeError, match="failed to launch"):
        _launch(odd, flow, res, 8, stride=2)
    with pytest.raises(RuntimeError, match="failed to launch"):
        # grad_out of the (4 x 7) query grid the wrapper reckons for 9 x 14.
        _launch_backward(odd, flow, res, grad_out[:, :, :28].contiguous(), 8, stride=2)
    assert (deformable_sample.launches, deformable_sample.backward_launches) == before
