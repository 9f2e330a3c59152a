"""The port's CUDA kernel against its plain version, on the card.

``chip_smoke.py`` holds the kernel against its plain version at the DAT
level shapes and its edge cases; these tests add what it does not cover:
odd sizes with many groups and large residuals, and one counted launch
per call.

These tests need an NVIDIA card with nvcc (the kernel has no CPU mode) and
skip without one. On the card's machine, which has no JAX, run them without
the JAX test configuration::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from videoframeinterpolation_tpu_torch.kernels import deformable_sample, deformable_sample_plain

pytestmark = pytest.mark.cuda

TOL = 1e-5   # same taps in the same order, products and sums without FMA


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the deformable_sample kernel has no CPU mode")
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
    before = deformable_sample.launches
    deformable_sample(feat, flow, res, 1)
    deformable_sample(feat, flow, res, 1)
    assert deformable_sample.launches == before + 2
