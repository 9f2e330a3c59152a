"""The sampler's backward on the CPU: its plan, and its oracle against JAX.

``kernels/window_sample.py:_backward_plan`` decides per call how the
backward kernel sums ``grad_feat`` (in shared memory, a block per slice of
``k`` channels of one image, or with global atomics) and at what index
width. These tests hold the plan at every level shape the port's paths
launch: the student (``configs/DAT_fast.yaml``: G 1, S 8/8/2), the teacher
(G 1, S 8/16/8) and the non-shared checkpoint (``configs/DAT.yaml``: G
4/8/8, S 8/16/32), each at a 448x256 request (B2 2), a training or
evaluation batch (8 pairs of 128x128, B2 16) and a 1080p request (B2 2,
padded to 1088x1920); the plan is the same in either dtype. They also hold
the card's figures and the feature kernel's block size, which the plan
reads, to the ``-D`` flags the kernels are compiled with.

The plain backward (``deformable_sample_backward_plain``, the oracle of
both paths of the kernel) is held to ``jax.grad`` of the JAX package's
``_grouped_deformable_sample`` at the edge cases that
``tests/test_torch_grad.py`` does not cover: integer coordinates, every tap
outside the image, every sample of every query on one pixel, and G 3 with
groups of 7 channels. Tolerance as there: each gradient within 1e-5 of its
max abs (the two frameworks sum in different orders); a gradient that is
zero in JAX must be exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoframeinterpolation_tpu.nn.deformable_attn import (
    _grouped_deformable_sample as jax_grouped_sample)
from videoframeinterpolation_tpu_torch.kernels import build, deformable_sample_backward_plain
from videoframeinterpolation_tpu_torch.kernels.build import (
    BWD_FEAT_THREADS, SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED, SMS, THREADS_PER_SM)
from videoframeinterpolation_tpu_torch.kernels.window_sample import _backward_plan

REL_TOL = 1e-5
C = 72
# name -> (G, S) per level lv3, lv2, lv1.
CONFIGS = {"student": ((1, 8), (1, 8), (1, 2)),
           "teacher": ((1, 8), (1, 16), (1, 8)),
           "non_shared": ((4, 8), (8, 16), (8, 32))}
# name -> (B2, H, W) of the input; the levels are 1/8, 1/4 and 1/2 of it.
REQUESTS = {"request_448x256": (2, 256, 448),
            "batch_128x128": (16, 128, 128),
            "request_1080p": (2, 1088, 1920)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _level(config, request, level):
    B2, H, W = REQUESTS[request]
    i = ("lv3", "lv2", "lv1").index(level)
    G, S = CONFIGS[config][i]
    d = (8, 4, 2)[i]
    return B2, H // d, W // d, C, G, S


@pytest.mark.parametrize("level", ["lv3", "lv2", "lv1"])
@pytest.mark.parametrize("request_", list(REQUESTS))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_backward_plan_at_every_level_shape(config, request_, level):
    B2, H, W, C_, G, S = _level(config, request_, level)
    plan = _backward_plan(B2, H, W, C_, G, S)
    assert plan.index_bits == (64 if B2 * H * W * S * C_ >= 2 ** 31 else 32)
    # A one-channel slice leaves room for two blocks per SM up to 28672
    # pixels: a 448x256 request's lv1 (128x224) just fits, and no level of a
    # 1080p request does (its lv3 is 136x240).
    if request_ == "request_1080p":
        assert plan == ("global", 0, 0, plan.index_bits)
        return
    assert plan.path == "smem"
    assert (C_ // G) % plan.k == 0
    assert plan.smem_bytes == H * W * plan.k * 4 <= SMEM_PER_BLOCK
    assert 2 * (plan.smem_bytes + SMEM_RESERVED) <= SMEM_PER_SM
    # Every level shape here gets a grid of one wave: no block waits for a
    # slot while the others run.
    per_sm = min(THREADS_PER_SM // ((BWD_FEAT_THREADS // plan.k) * plan.k),
                 SMEM_PER_SM // (plan.smem_bytes + SMEM_RESERVED))
    assert B2 * (C_ // plan.k) <= SMS * per_sm


def test_training_levels_take_3_channels_per_block():
    """The student's training levels (B2 16, 16x16 / 32x32 / 64x64): 3 KB,
    12 KB and 48 KB of shared memory per block and 384 blocks of 510
    threads, one wave of the card's 132 x 4 slots. (One or two channels per
    block take two or three waves; four or more leave slots idle.)"""
    plans = [_backward_plan(*_level("student", "batch_128x128", lv))
             for lv in ("lv3", "lv2", "lv1")]
    assert [tuple(p) for p in plans] == [("smem", 3, 3072, 32), ("smem", 3, 12288, 32),
                                         ("smem", 3, 49152, 32)]


@pytest.mark.parametrize("Cg,k", [(9, 3), (7, 1), (18, 3), (72, 3)])
def test_narrow_groups_take_a_slice_that_divides_the_group(Cg, k):
    """Groups of 9, 7, 18 and 72 channels (the non-shared levels, an odd
    group, one group) at a 64x64 level of 16 frames: the fewest waves, then
    the smallest slice. Groups of 7 in 21 channels fill one wave one channel
    at a time."""
    G = 72 // Cg if 72 % Cg == 0 else 3
    plan = _backward_plan(16, 64, 64, G * Cg, G, 8)
    assert (plan.path, plan.k) == ("smem", k)


@pytest.mark.parametrize("name", list(build.DEFINES))
def test_the_kernels_take_the_plans_figures_from_the_build(name):
    """Each figure the plan reads and the sampler's source needs reaches
    ``nvcc`` as a ``-D`` flag, and the source holds no copy of its value."""
    source = (build._CSRC / "deformable_sample.cu").read_text()
    value = build.DEFINES[name]
    assert f"-D{name}={value}" in build.NVCC_FLAGS
    assert name in source
    assert f"= {value};" not in source


def test_the_feature_kernels_launch_bound_fills_an_sm_with_threads():
    """The shared-memory feature kernel is compiled for
    ``THREADS_PER_SM // BWD_FEAT_THREADS`` resident blocks, so registers
    never hold fewer blocks per SM than the plan counts: every block size
    the plan makes, ``(BWD_FEAT_THREADS // k) * k``, fits that many times."""
    blocks = THREADS_PER_SM // BWD_FEAT_THREADS
    assert blocks * BWD_FEAT_THREADS == THREADS_PER_SM and blocks >= 2
    assert SMEM_PER_BLOCK + SMEM_RESERVED <= SMEM_PER_SM


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _edge_case(name):
    """``feat, flow, residual, cotangent, G`` of an edge case, fp32 numpy."""
    rng = np.random.default_rng({"integer": 10, "all_outside": 11, "one_pixel": 12,
                                 "g3_cg7": 13}[name])
    B2, H, W, G, S = 2, 6, 9, 1, 4
    Cg = 16
    if name == "g3_cg7":
        G, Cg = 3, 7
    C_ = G * Cg
    feat = _rand(rng, B2, H, W, C_)
    res = (3.0 * np.tanh(_rand(rng, B2, H, W, G, S, 2))).astype(np.float32)
    flow = _rand(rng, B2, H, W, 2, scale=3.0)
    if name == "integer":
        # Every coordinate on a pixel, some on the last row and column and
        # some beyond them.
        res, flow = np.round(res), np.round(flow)
    elif name == "all_outside":
        flow = np.where(rng.random((B2, H, W, 2)) < 0.5, 1e4, -1e4).astype(np.float32)
    elif name == "one_pixel":
        gy, gx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                             indexing="ij")
        flow = np.broadcast_to(np.stack([3.25 - gx, 2.5 - gy], -1), (B2, H, W, 2)).copy()
        res = np.zeros_like(res)
    cot = _rand(rng, B2, S, H * W, C_)
    return feat, flow, res, cot, G


@pytest.mark.parametrize("name", ["integer", "all_outside", "one_pixel", "g3_cg7"])
def test_plain_backward_matches_jax_at_edge_cases(name):
    feat, flow, res, cot, G = _edge_case(name)
    got = deformable_sample_backward_plain(*(torch.from_numpy(x) for x in (feat, flow, res, cot)),
                                           G)
    ref = jax.jit(jax.grad(
        lambda f, fl, r: jnp.sum(jax_grouped_sample(f, r + fl[:, :, :, None, None, :], G) * cot),
        argnums=(0, 1, 2)))(feat, flow, res)
    for g, r, which in zip(got, ref, ("feat", "flow", "residual")):
        r = np.asarray(r, np.float64)
        g = g.double().numpy()
        assert g.shape == r.shape, which
        err = np.abs(g - r).max()
        assert err <= REL_TOL * np.abs(r).max(), f"grad_{which}: {err} of {np.abs(r).max()}"
    if name == "all_outside":
        assert all(not g.any() for g in got)
    if name == "one_pixel":
        # Every tap of every sample lands on (3, 2), (4, 2), (3, 3), (4, 3).
        nz = np.nonzero(np.abs(got[0].numpy()).sum(-1))
        assert sorted(set(zip(nz[1].tolist(), nz[2].tolist()))) == [(2, 3), (2, 4), (3, 3),
                                                                     (3, 4)]
