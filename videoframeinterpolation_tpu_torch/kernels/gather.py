"""Row and lane gathers of a 2-D table: hand-written CUDA kernels and their plain versions.

Counterparts of the two Pallas probes of ``tools/perf``:

  * :func:`row_gather`, ``out[i, j] = x[idx[i, j], j]``
    (``jnp.take_along_axis(x, idx, axis=0)``, the kernel of
    ``tools/perf/pallas_gather_probe.py:make_gather``);
  * :func:`lane_gather`, ``out[i, j] = x[i, idx[i, j]]``
    (``jnp.take_along_axis(x, idx, axis=1)``, the kernel of
    ``tools/perf/pallas_lane_gather_probe.py:make``).

Both kernels are in ``csrc/gather.cu``. The indices are int32 and must be
in range (``[0, M)`` for the row gather, ``[0, N)`` for the lane gather),
as both probes draw them: the kernels do not check them, and a check on
the device would cost a synchronisation. The plain versions, advanced
indexing, raise on an index out of range.

The row gather does its index math in 32 bits unless an index of the
call reaches 2^31 (:func:`_row_index_bits`).

Each wrapper launches its kernel on a CUDA tensor, on the current stream,
and adds one to its ``launches``; on a CPU tensor it runs the plain
version. It never falls back from one to the other: a launch the kernel
refuses raises.
"""

from __future__ import annotations

import torch

from .build import load_library

_ROW = {torch.float32: "vfi_row_gather_f32", torch.bfloat16: "vfi_row_gather_bf16"}
_LANE = {torch.float32: "vfi_lane_gather_f32", torch.bfloat16: "vfi_lane_gather_bf16"}


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = x[idx[i, j], j]`` by advanced indexing."""
    cols = torch.arange(x.shape[1], device=x.device)
    return x[idx.long(), cols[None, :]]


def lane_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = x[i, idx[i, j]]`` by advanced indexing."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows[:, None], idx.long()]


def _check(x: torch.Tensor, idx: torch.Tensor, axis: int) -> None:
    if x.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"expected a 2-D table and 2-D indices; got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}")
    other = 1 - axis
    if idx.shape[other] != x.shape[other]:
        raise ValueError(f"indices {tuple(idx.shape)} do not match the table {tuple(x.shape)} "
                         f"on axis {other}")
    if min(*x.shape, *idx.shape) <= 0:
        raise ValueError(f"empty table or indices: {tuple(x.shape)}, {tuple(idx.shape)}")
    if x.dtype not in _ROW:
        raise TypeError(f"table dtype {x.dtype}; expected one of {list(_ROW)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"index dtype {idx.dtype}; expected torch.int32")
    if x.device != idx.device:
        raise ValueError(f"table on {x.device}, indices on {idx.device}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and indices must be contiguous")


def _launch(name: str, x: torch.Tensor, idx: torch.Tensor, K: int, *args: int) -> torch.Tensor:
    """``name(x, idx, out, M, N, K, *args, stream)`` on the current stream;
    raises if the kernel refuses the call."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    M, N = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(load_library(), name)(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                            M, N, K, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name}{tuple(args)} failed to launch: cudaError {err}")
    return out


def _row_index_bits(M: int, N: int, K: int) -> int:
    """32 when every element index of ``x (M, N)`` and ``idx (K, N)`` is
    below 2^31, else 64."""
    return 32 if max(K, M) * N < 2 ** 31 else 64


def _row_gather_launch(x: torch.Tensor, idx: torch.Tensor, index_bits: int | None = None
                       ) -> torch.Tensor:
    """Launch ``vfi_row_gather_*`` on checked tensors with the index width
    of :func:`_row_index_bits` unless given, and count the launch. The
    kernel refuses a width that the call does not fit, and the refusal
    raises."""
    (M, N), K = x.shape, idx.shape[0]
    if index_bits is None:
        index_bits = _row_index_bits(M, N, K)
    out = _launch(_ROW[x.dtype], x, idx, K, index_bits)
    row_gather.launches += 1
    return out


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = x[idx[i, j], j]`` for ``x (M, N)`` fp32 or bf16 and
    ``idx (K, N)`` int32 in ``[0, M)``; returns ``(K, N)`` in ``x``'s dtype."""
    _check(x, idx, axis=0)
    if x.device.type == "cpu":
        return row_gather_plain(x, idx)
    return _row_gather_launch(x, idx)


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = x[i, idx[i, j]]`` for ``x (M, N)`` fp32 or bf16 and
    ``idx (M, K)`` int32 in ``[0, N)``; returns ``(M, K)`` in ``x``'s dtype."""
    _check(x, idx, axis=1)
    if x.device.type == "cpu":
        return lane_gather_plain(x, idx)
    out = _launch(_LANE[x.dtype], x, idx, K=idx.shape[1])
    lane_gather.launches += 1
    return out


row_gather.launches = 0
lane_gather.launches = 0
