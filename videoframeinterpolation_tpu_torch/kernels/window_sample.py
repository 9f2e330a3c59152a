"""The DAT levels' deformable sampler: a hand-written CUDA kernel and its plain version.

Counterpart of ``videoframeinterpolation_tpu/kernels/window_sample.py:
windowed_deformable_sample``, the JAX package's Pallas kernel. That kernel
is a drop-in for ``_grouped_deformable_sample(feat, residual + flow, G)``
whenever ``|residual| <= offset_scale``, which the flagship guarantees by
construction (``res = offset_scale * tanh(...)``). The port computes that
function directly, for any residual, in ``csrc/deformable_sample.cu``, on
a query grid equal to the feature grid or ``stride`` times coarser (JAX
``_grouped_deformable_sample(..., stride)``, the ``attn_stride`` variant's
level 1, whose queries sit at the centres of ``stride x stride`` cells and
sample the full-resolution features).

:func:`deformable_sample` launches the kernel on a CUDA tensor and runs
:func:`deformable_sample_plain` on a CPU tensor; it never falls back from
one to the other. Where a gradient is asked for on the card it goes through
:class:`DeformableSample`, whose backward is the hand-written
``vfi_deformable_sample_bwd_*`` entry point of the same source (two
kernels, on the path :func:`_backward_plan` picks); on the CPU, autograd
differentiates the plain version, as XLA differentiates the JAX model's
``_grouped_deformable_sample``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.interp import grid_sample
from ..ops.warp import base_grid
from .build import (BWD_FEAT_THREADS, SMEM_PER_SM, SMEM_RESERVED, SMS, THREADS_PER_SM,
                    load_library)

_KERNELS = {torch.float32: "vfi_deformable_sample_f32",
            torch.bfloat16: "vfi_deformable_sample_bf16"}
_BACKWARD_KERNELS = {torch.float32: "vfi_deformable_sample_bwd_f32",
                     torch.bfloat16: "vfi_deformable_sample_bwd_bf16"}
_BACKWARD_PATHS = {"global": 0, "smem": 1}   # the C entry point's path codes


def _grouped_deformable_sample(feat: torch.Tensor, ref_offsets: torch.Tensor,
                               n_groups: int, stride: int = 1) -> torch.Tensor:
    """Sample grouped features at per-group deformable locations.

    Args:
      feat: ``(B, H, W, C)``; channels split into ``n_groups`` groups.
      ref_offsets: ``(B, h, w, G, S, 2)`` pixel displacements ``(dx, dy)``
        from each query position, with ``(h, w) = (H, W) // stride``.
      stride: the query grid's stride over ``feat``: query ``(i, j)`` sits
        at ``(j * stride + (stride - 1) / 2, i * stride + (stride - 1) / 2)``
        (:func:`..ops.warp.base_grid`), the centre of its cell.

    Returns:
      ``(B, S, h*w, C)``, zeros out of bounds.
    """
    B, H, W, C = feat.shape
    G = n_groups
    h, w = ref_offsets.shape[1:3]
    S = ref_offsets.shape[4]
    Cg = C // G
    coords = (base_grid(h, w, feat.device, stride)[None, :, :, None, None, :]
              + ref_offsets.float())
    feat_g = feat.reshape(B, H, W, G, Cg).permute(0, 3, 1, 2, 4).reshape(B * G, H, W, Cg)
    coords_g = coords.permute(0, 3, 4, 1, 2, 5).reshape(B * G, S, h, w, 2)
    samples = grid_sample(feat_g, coords_g, padding_mode="zeros")
    samples = samples.reshape(B, G, S, h, w, Cg).permute(0, 2, 3, 4, 1, 5)
    return samples.reshape(B, S, h * w, C)


def deformable_sample_plain(feat: torch.Tensor, flow: torch.Tensor,
                            residual: torch.Tensor, n_groups: int,
                            stride: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the CPU path and the
    kernel's oracle). ``residual + flow`` is taken in fp32, as XLA takes the
    JAX model's ``res + flow`` that it then casts to fp32."""
    return _grouped_deformable_sample(
        feat, residual.float() + flow.float()[:, :, :, None, None, :], n_groups, stride)


def deformable_sample_backward_plain(feat: torch.Tensor, flow: torch.Tensor,
                                     residual: torch.Tensor, grad_out: torch.Tensor,
                                     n_groups: int, stride: int = 1):
    """The backward kernel's function in plain PyTorch (its oracle):
    autograd through :func:`deformable_sample_plain` on the inputs and
    ``grad_out`` taken to fp32, each gradient rounded once to its input's
    dtype. Returns ``(grad_feat, grad_flow, grad_residual)``."""
    with torch.enable_grad():
        leaves = [x.detach().float().requires_grad_() for x in (feat, flow, residual)]
        out = deformable_sample_plain(*leaves, n_groups, stride)
        grads = torch.autograd.grad(out, leaves, grad_out.float())
    return tuple(g.to(x.dtype) for g, x in zip(grads, (feat, flow, residual)))


def _check(feat: torch.Tensor, flow: torch.Tensor, residual: torch.Tensor,
           n_groups: int, stride: int = 1) -> None:
    if feat.dim() != 4 or flow.dim() != 4 or residual.dim() != 6:
        raise ValueError("expected feat (B2,H,W,C), flow (B2,h,w,2), residual "
                         f"(B2,h,w,G,S,2); got {tuple(feat.shape)}, "
                         f"{tuple(flow.shape)}, {tuple(residual.shape)}")
    B2, H, W, C = feat.shape
    if stride < 1 or H % stride or W % stride:
        raise ValueError(f"stride {stride} does not divide feat {tuple(feat.shape)}")
    h, w = H // stride, W // stride
    if tuple(flow.shape) != (B2, h, w, 2):
        raise ValueError(f"flow {tuple(flow.shape)} does not match feat {tuple(feat.shape)} "
                         f"at stride {stride}")
    if tuple(residual.shape[:4]) != (B2, h, w, n_groups) or residual.shape[5] != 2:
        raise ValueError(f"residual {tuple(residual.shape)} does not match "
                         f"feat {tuple(feat.shape)} at stride {stride} with {n_groups} groups")
    if min(B2, H, W, C, residual.shape[4]) <= 0 or n_groups <= 0 or C % n_groups:
        raise ValueError(f"empty shape or {n_groups} groups not dividing {C} channels")
    if feat.dtype not in _KERNELS or flow.dtype != feat.dtype or residual.dtype != feat.dtype:
        raise TypeError("feat, flow and residual must share one dtype of "
                        f"{list(_KERNELS)}; got {feat.dtype}, {flow.dtype}, {residual.dtype}")
    if not (flow.device == feat.device == residual.device):
        raise ValueError("feat, flow and residual must be on one device")
    if not (feat.is_contiguous() and flow.is_contiguous() and residual.is_contiguous()):
        raise ValueError("feat, flow and residual must be contiguous")


def _vector_bytes(C: int, G: int, element_size: int, *ptrs: int) -> int:
    """Bytes per load and store of the kernel: the widest of 16, 8, 4 and 2
    that divides a group's ``C // G`` channels and every base pointer in
    ``ptrs`` (feat's and out's), and never less than one element. A
    contiguous tensor with a storage offset may be aligned to one element
    only; it then takes the element's width."""
    width = 16
    while width > element_size and ((C // G * element_size) % width
                                    or any(p % width for p in ptrs)):
        width //= 2
    return width


def _index_bits(B2: int, H: int, W: int, C: int, G: int, S: int, stride: int = 1) -> int:
    """32 when every element index of the call is below 2^31, else 64. The
    largest tensors are out ``(B2,S,h*w,C)`` and residual ``(B2,h,w,G,S,2)``
    on the query grid ``h x w = (H/stride) x (W/stride)``, and, on a strided
    grid, feat ``(B2,H,W,C)``."""
    queries = B2 * (H // stride) * (W // stride)
    return 32 if max(queries * S * max(C, 2 * G), B2 * H * W * C) < 2 ** 31 else 64


def _launch(feat: torch.Tensor, flow: torch.Tensor, residual: torch.Tensor, n_groups: int,
            vector_bytes: int | None = None, index_bits: int | None = None, *,
            stride: int = 1) -> torch.Tensor:
    """Launch ``vfi_deformable_sample_*`` on checked CUDA tensors, with the
    vector width and index width of :func:`_vector_bytes` and
    :func:`_index_bits` unless given; count the launch. The kernel refuses a
    width that does not fit the call, and the refusal raises."""
    B2, H, W, C = feat.shape
    S = residual.shape[4]
    hw = (H // stride) * (W // stride)
    out = torch.empty((B2, S, hw, C), dtype=feat.dtype, device=feat.device)
    if vector_bytes is None:
        vector_bytes = _vector_bytes(C, n_groups, feat.element_size(), feat.data_ptr(),
                                     out.data_ptr())
    if index_bits is None:
        index_bits = _index_bits(B2, H, W, C, n_groups, S, stride)
    fn = getattr(load_library(), _KERNELS[feat.dtype])
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feat.data_ptr(), flow.data_ptr(), residual.data_ptr(), out.data_ptr(),
                 B2, H, W, C, n_groups, S, stride, vector_bytes, index_bits, stream)
    if err != 0:
        raise RuntimeError(f"{_KERNELS[feat.dtype]} failed to launch ({vector_bytes}-byte "
                           f"vectors, {index_bits}-bit indices): cudaError {err}")
    deformable_sample.launches += 1
    if feat.dtype == torch.bfloat16:
        deformable_sample.bf16_launches += 1
    if stride > 1:
        deformable_sample.strided_launches += 1
    return out


class BackwardPlan(NamedTuple):
    """How the backward computes ``grad_feat`` for one call: ``path``
    ``"smem"`` (a block per (frame, slice of ``k`` channels of one group),
    the slice's fp32 gradient for the whole image in ``smem_bytes`` of
    shared memory) or ``"global"`` (global fp32 atomics into a zeroed
    buffer, rounded once; ``k`` and ``smem_bytes`` are 0), and the index
    width of every kernel of the call."""
    path: str
    k: int
    smem_bytes: int
    index_bits: int


def _backward_plan(B2: int, H: int, W: int, C: int, G: int, S: int,
                   stride: int = 1) -> BackwardPlan:
    """The backward's plan for a call. ``"smem"`` wherever a slice of
    ``k`` channels (``k`` dividing a group's ``C // G``) leaves room for two
    blocks per SM (``H * W * k * 4`` bytes each); of those ``k``, the one
    whose ``B2 * C / k`` blocks take the fewest waves of the card (blocks of
    ``(BWD_FEAT_THREADS // k) * k`` threads, as many per SM as threads and
    shared memory allow: the kernel's ``__launch_bounds__`` keeps registers
    from allowing fewer), then the smallest ``k`` (the most blocks in that
    wave). ``"global"`` where even ``k = 1`` does not fit twice per SM.
    ``H x W`` is the feature grid, whose gradient the blocks hold whatever
    the query grid's ``stride``. Index width as :func:`_index_bits`. The
    card's figures and the block size are :mod:`.build`'s, which the kernels
    are compiled with."""
    bits = _index_bits(B2, H, W, C, G, S, stride)
    per_channel = H * W * 4
    fits = [k for k in range(1, min(C // G, BWD_FEAT_THREADS) + 1)
            if (C // G) % k == 0 and 2 * (k * per_channel + SMEM_RESERVED) <= SMEM_PER_SM]
    if not fits:
        return BackwardPlan("global", 0, 0, bits)

    def waves(k: int) -> int:
        per_sm = min(THREADS_PER_SM // ((BWD_FEAT_THREADS // k) * k),
                     SMEM_PER_SM // (k * per_channel + SMEM_RESERVED))
        return -(-B2 * (C // k) // (SMS * per_sm))

    k = min(fits, key=lambda k: (waves(k), k))
    return BackwardPlan("smem", k, k * per_channel, bits)


def _launch_backward(feat: torch.Tensor, flow: torch.Tensor, residual: torch.Tensor,
                     grad_out: torch.Tensor, n_groups: int, vector_bytes: int | None = None,
                     index_bits: int | None = None, plan: BackwardPlan | None = None, *,
                     stride: int = 1):
    """Launch ``vfi_deformable_sample_bwd_*`` on checked CUDA tensors
    (``grad_out`` contiguous, ``(B2, S, h*w, C)`` on the query grid of
    ``stride``, in ``feat``'s dtype) and
    count the launch, in ``deformable_sample.backward_launches`` and under
    its path in ``deformable_sample.backward_path_launches``. Returns
    ``(grad_feat, grad_flow, grad_residual)`` in the inputs' dtype.

    One call runs two kernels (``csrc/deformable_sample.cu``): the feature
    kernel on a side stream (one per host thread and device) forked from
    the current one, the coordinate kernel on the current stream beside it,
    joined before the call returns.
    The coordinate kernel sums ``grad_residual`` and ``grad_flow`` in fp32
    without atomics, in a fixed order, and rounds each once: they are the
    same bits on every run. The feature kernel follows ``plan``
    (:func:`_backward_plan` unless given): on ``"smem"`` each block sums its
    slice of ``grad_feat`` in shared memory and writes it once in the
    inputs' dtype (no buffer to zero, nothing to cast); on ``"global"`` it
    adds into a zeroed fp32 buffer that is then rounded once. Atomics on
    both paths add in a changing order, so ``grad_feat`` is not
    bit-reproducible. Vector width as in :func:`_launch` (``grad_out``
    takes ``out``'s place; the shared-memory path's feature kernel reads one
    element per lane); ``index_bits``, if given, replaces the plan's. The
    kernels refuse a width or a plan that does not fit the call (a slice
    that does not divide a group, exceeds 227 KB or 512 channels, more than
    256 chunks per pixel); nothing is launched then, and the refusal
    raises."""
    B2, H, W, C = feat.shape
    S = residual.shape[4]
    hw = (H // stride) * (W // stride)
    if tuple(grad_out.shape) != (B2, S, hw, C) or grad_out.dtype != feat.dtype:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} {grad_out.dtype} does not match "
                         f"the output {(B2, S, hw, C)} {feat.dtype}")
    if grad_out.device != feat.device or not grad_out.is_contiguous():
        raise ValueError("grad_out must be contiguous and on feat's device")
    if plan is None:
        plan = _backward_plan(B2, H, W, C, n_groups, S, stride)
    if index_bits is not None:
        plan = plan._replace(index_bits=index_bits)
    if plan.path == "smem":
        grad_feat = torch.empty_like(feat)
    else:
        grad_feat = torch.zeros(feat.shape, dtype=torch.float32, device=feat.device)
    grad_flow = torch.empty_like(flow)
    grad_residual = torch.empty_like(residual)
    if vector_bytes is None:
        vector_bytes = _vector_bytes(C, n_groups, feat.element_size(), feat.data_ptr(),
                                     grad_out.data_ptr())
    name = _BACKWARD_KERNELS[feat.dtype]
    fn = getattr(load_library(), name)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feat.data_ptr(), flow.data_ptr(), residual.data_ptr(), grad_out.data_ptr(),
                 grad_feat.data_ptr(), grad_residual.data_ptr(), grad_flow.data_ptr(),
                 B2, H, W, C, n_groups, S, stride, vector_bytes, plan.index_bits,
                 _BACKWARD_PATHS.get(plan.path, -1), plan.k, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch ({vector_bytes}-byte vectors, "
                           f"plan {plan}): cudaError {err}")
    deformable_sample.backward_launches += 1
    deformable_sample.backward_path_launches[plan.path] += 1
    if stride > 1:
        deformable_sample.strided_backward_launches += 1
    return grad_feat.to(feat.dtype), grad_flow, grad_residual


class DeformableSample(torch.autograd.Function):
    """The sampler on the card with a gradient: forward :func:`_launch`,
    backward :func:`_launch_backward` on its planned path (two hand-written
    kernels, one counted launch). ``grad_residual`` and ``grad_flow`` are
    reproducible bit for bit; ``grad_feat``, summed with atomics, is not.
    Both directions allocate nothing that depends on the data and never
    synchronise with the host, so a CUDA graph can capture them."""

    @staticmethod
    def forward(ctx, feat, flow, residual, n_groups, stride):
        ctx.save_for_backward(feat, flow, residual)
        ctx.n_groups, ctx.stride = n_groups, stride
        return _launch(feat, flow, residual, n_groups, stride=stride)

    @staticmethod
    def backward(ctx, grad_out):
        feat, flow, residual = ctx.saved_tensors
        grads = _launch_backward(feat, flow, residual, grad_out.contiguous(), ctx.n_groups,
                                 stride=ctx.stride)
        return (*grads, None, None)


def deformable_sample(feat: torch.Tensor, flow: torch.Tensor, residual: torch.Tensor,
                      n_groups: int, stride: int = 1) -> torch.Tensor:
    """Zeros-padded bilinear samples of ``feat`` at ``q + (residual + flow)``.

    Args:
      feat: ``(B2, H, W, C)``.
      flow: ``(B2, h, w, 2)``, shared by every group and sample.
      residual: ``(B2, h, w, G, S, 2)``.
      n_groups: ``G``, which divides ``C``.
      stride: the query grid's stride over ``feat``: ``h = H / stride`` and
        ``w = W / stride``, query ``(i, j)`` at ``(j * stride + (stride -
        1) / 2, i * stride + (stride - 1) / 2)``; 1 (every pixel a query)
        at every level but the ``attn_stride`` variant's level 1.

    Returns:
      ``(B2, S, h*w, C)``, in ``feat``'s dtype (fp32 or bf16).

    On a CUDA tensor this launches ``vfi_deformable_sample_*`` on the
    current stream, with the vector width and index width chosen for this
    call (:func:`_vector_bytes`, :func:`_index_bits`), and adds one to
    ``deformable_sample.launches`` (and, for bf16, to
    ``deformable_sample.bf16_launches``; on a strided grid, to
    ``deformable_sample.strided_launches``); where autograd records the
    call, it goes through :class:`DeformableSample`, whose backward launches
    ``vfi_deformable_sample_bwd_*`` and adds one to
    ``deformable_sample.backward_launches``, to its path's count in
    ``deformable_sample.backward_path_launches`` and, on a strided grid, to
    ``deformable_sample.strided_backward_launches``. On a CPU tensor it runs
    :func:`deformable_sample_plain` (differentiable by autograd).
    """
    _check(feat, flow, residual, n_groups, stride)
    if feat.device.type == "cpu":
        return deformable_sample_plain(feat, flow, residual, n_groups, stride)
    if feat.device.type != "cuda":
        raise ValueError(f"unsupported device {feat.device}")
    if torch.is_grad_enabled() and (feat.requires_grad or flow.requires_grad
                                    or residual.requires_grad):
        return DeformableSample.apply(feat, flow, residual, n_groups, stride)
    return _launch(feat, flow, residual, n_groups, stride=stride)


deformable_sample.launches = 0
deformable_sample.bf16_launches = 0
deformable_sample.backward_launches = 0
deformable_sample.backward_path_launches = dict.fromkeys(_BACKWARD_PATHS, 0)
deformable_sample.strided_launches = 0
deformable_sample.strided_backward_launches = 0
