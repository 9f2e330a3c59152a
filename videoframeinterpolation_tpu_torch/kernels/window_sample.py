"""The DAT levels' deformable sampler: a hand-written CUDA kernel and its plain version.

Counterpart of ``videoframeinterpolation_tpu/kernels/window_sample.py:
windowed_deformable_sample``, the JAX package's Pallas kernel. That kernel
is a drop-in for ``_grouped_deformable_sample(feat, residual + flow, G)``
whenever ``|residual| <= offset_scale``, which the flagship guarantees by
construction (``res = offset_scale * tanh(...)``). The port computes that
function directly, for any residual, in ``csrc/deformable_sample.cu``.

:func:`deformable_sample` launches the kernel on a CUDA tensor and runs
:func:`deformable_sample_plain` on a CPU tensor; it never falls back from
one to the other.
"""

from __future__ import annotations

import torch

from ..ops.interp import grid_sample
from ..ops.warp import base_grid
from .build import load_library

_KERNELS = {torch.float32: "vfi_deformable_sample_f32",
            torch.bfloat16: "vfi_deformable_sample_bf16"}


def _grouped_deformable_sample(feat: torch.Tensor, ref_offsets: torch.Tensor,
                               n_groups: int) -> torch.Tensor:
    """Sample grouped features at per-group deformable locations.

    Args:
      feat: ``(B, H, W, C)``; channels split into ``n_groups`` groups.
      ref_offsets: ``(B, H, W, G, S, 2)`` pixel displacements ``(dx, dy)``
        from each query position.

    Returns:
      ``(B, S, H*W, C)``, zeros out of bounds.
    """
    B, H, W, C = feat.shape
    G = n_groups
    S = ref_offsets.shape[4]
    Cg = C // G
    coords = base_grid(H, W, feat.device)[None, :, :, None, None, :] + ref_offsets.float()
    feat_g = feat.reshape(B, H, W, G, Cg).permute(0, 3, 1, 2, 4).reshape(B * G, H, W, Cg)
    coords_g = coords.permute(0, 3, 4, 1, 2, 5).reshape(B * G, S, H, W, 2)
    samples = grid_sample(feat_g, coords_g, padding_mode="zeros")
    samples = samples.reshape(B, G, S, H, W, Cg).permute(0, 2, 3, 4, 1, 5)
    return samples.reshape(B, S, H * W, C)


def deformable_sample_plain(feat: torch.Tensor, flow: torch.Tensor,
                            residual: torch.Tensor, n_groups: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the CPU path and the
    kernel's oracle). ``residual + flow`` is taken in fp32, as XLA takes the
    JAX model's ``res + flow`` that it then casts to fp32."""
    return _grouped_deformable_sample(
        feat, residual.float() + flow.float()[:, :, :, None, None, :], n_groups)


def _check(feat: torch.Tensor, flow: torch.Tensor, residual: torch.Tensor,
           n_groups: int) -> None:
    if feat.dim() != 4 or flow.dim() != 4 or residual.dim() != 6:
        raise ValueError("expected feat (B2,H,W,C), flow (B2,H,W,2), residual "
                         f"(B2,H,W,G,S,2); got {tuple(feat.shape)}, "
                         f"{tuple(flow.shape)}, {tuple(residual.shape)}")
    B2, H, W, C = feat.shape
    if tuple(flow.shape) != (B2, H, W, 2):
        raise ValueError(f"flow {tuple(flow.shape)} does not match feat {tuple(feat.shape)}")
    if tuple(residual.shape[:4]) != (B2, H, W, n_groups) or residual.shape[5] != 2:
        raise ValueError(f"residual {tuple(residual.shape)} does not match "
                         f"feat {tuple(feat.shape)} with {n_groups} groups")
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


def _index_bits(B2: int, H: int, W: int, C: int, G: int, S: int) -> int:
    """32 when every element index of the call (out ``(B2,S,H*W,C)`` and
    residual ``(B2,H,W,G,S,2)``, the two largest tensors) is below 2^31,
    else 64."""
    return 32 if B2 * H * W * S * max(C, 2 * G) < 2 ** 31 else 64


def _launch(feat: torch.Tensor, flow: torch.Tensor, residual: torch.Tensor, n_groups: int,
            vector_bytes: int | None = None, index_bits: int | None = None) -> torch.Tensor:
    """Launch ``vfi_deformable_sample_*`` on checked CUDA tensors, with the
    vector width and index width of :func:`_vector_bytes` and
    :func:`_index_bits` unless given; count the launch. The kernel refuses a
    width that does not fit the call, and the refusal raises."""
    B2, H, W, C = feat.shape
    S = residual.shape[4]
    out = torch.empty((B2, S, H * W, C), dtype=feat.dtype, device=feat.device)
    if vector_bytes is None:
        vector_bytes = _vector_bytes(C, n_groups, feat.element_size(), feat.data_ptr(),
                                     out.data_ptr())
    if index_bits is None:
        index_bits = _index_bits(B2, H, W, C, n_groups, S)
    fn = getattr(load_library(), _KERNELS[feat.dtype])
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feat.data_ptr(), flow.data_ptr(), residual.data_ptr(), out.data_ptr(),
                 B2, H, W, C, n_groups, S, vector_bytes, index_bits, stream)
    if err != 0:
        raise RuntimeError(f"{_KERNELS[feat.dtype]} failed to launch ({vector_bytes}-byte "
                           f"vectors, {index_bits}-bit indices): cudaError {err}")
    deformable_sample.launches += 1
    if feat.dtype == torch.bfloat16:
        deformable_sample.bf16_launches += 1
    return out


def deformable_sample(feat: torch.Tensor, flow: torch.Tensor, residual: torch.Tensor,
                      n_groups: int) -> torch.Tensor:
    """Zeros-padded bilinear samples of ``feat`` at ``q + (residual + flow)``.

    Args:
      feat: ``(B2, H, W, C)``.
      flow: ``(B2, H, W, 2)``, shared by every group and sample.
      residual: ``(B2, H, W, G, S, 2)``.
      n_groups: ``G``, which divides ``C``.

    Returns:
      ``(B2, S, H*W, C)``, in ``feat``'s dtype (fp32 or bf16).

    On a CUDA tensor this launches ``vfi_deformable_sample_*`` on the
    current stream, with the vector width and index width chosen for this
    call (:func:`_vector_bytes`, :func:`_index_bits`), and adds one to
    ``deformable_sample.launches`` (and, for bf16, to
    ``deformable_sample.bf16_launches``); on a CPU tensor it runs
    :func:`deformable_sample_plain`.
    """
    _check(feat, flow, residual, n_groups)
    if feat.device.type == "cpu":
        return deformable_sample_plain(feat, flow, residual, n_groups)
    if feat.device.type != "cuda":
        raise ValueError(f"unsupported device {feat.device}")
    return _launch(feat, flow, residual, n_groups)


deformable_sample.launches = 0
deformable_sample.bf16_launches = 0
