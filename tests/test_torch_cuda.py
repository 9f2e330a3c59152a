"""The port's CUDA kernels against their plain versions, on the card.

``chip_smoke.py`` holds the kernels against their plain versions at the
shapes of the serving path and of the gather probes; these tests add what
it does not cover: odd sizes (the sampler with many groups and large
residuals, the gathers at a table height that is no multiple of 32), and
one counted launch per call.

These tests need an NVIDIA card with nvcc (the kernels have no CPU mode) and
skip without one. On the card's machine, which has no JAX, run them without
the JAX test configuration::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from videoframeinterpolation_tpu_torch.kernels import (
    deformable_sample, deformable_sample_plain, lane_gather, lane_gather_plain, row_gather,
    row_gather_plain)

pytestmark = pytest.mark.cuda

TOL = 1e-5   # same taps in the same order, products and sums without FMA


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


def test_kernel_matches_plain_version(gen):
    feat, flow, res = _inputs(gen, 1, 9, 13, 40, 8, 3, 30.0)
    out = deformable_sample(feat, flow, res, 8)
    torch.cuda.synchronize()
    ref = deformable_sample_plain(feat, flow, res, 8)
    assert (out - ref).abs().max().item() <= TOL


def test_each_call_is_one_counted_launch(gen):
    feat, flow, res = _inputs(gen, 2, 8, 8, 16, 1, 4, 2.0)
    before, before_bf16 = deformable_sample.launches, deformable_sample.bf16_launches
    deformable_sample(feat, flow, res, 1)
    deformable_sample(feat.bfloat16(), flow.bfloat16(), res.bfloat16(), 1)
    assert deformable_sample.launches == before + 2
    assert deformable_sample.bf16_launches == before_bf16 + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_matches_plain_version(gen, dtype):
    x = torch.randn((1001, 77), generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, 1001, (45, 77), generator=gen, device="cuda", dtype=torch.int32)
    before = row_gather.launches
    out = row_gather(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, row_gather_plain(x, idx))
    assert row_gather.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_gather_matches_plain_version(gen, dtype):
    x = torch.randn((1001, 77), generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, 77, (1001, 45), generator=gen, device="cuda", dtype=torch.int32)
    before = lane_gather.launches
    out = lane_gather(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, lane_gather_plain(x, idx))
    assert lane_gather.launches == before + 1
