"""Flax parameter trees <-> PyTorch parameters of the port's modules.

The port's modules carry the flax module names (``feature_encoder``,
``proj_res.block0``, ``movement_res.conv2_prelu``; IFRNet's
``encoder.p1_down``, ``decoder4.up``; DAT-TPU's ``dat_lv1.attn.k_proj``,
``dat_lv3.conv_group_offset``, ...), so a flax path ``a/b/kernel``
becomes the key ``a.b.weight``. Layout rules are those of
``videoframeinterpolation_tpu/interop/torch_export.py:36-49``:

  * Conv (kh, kw, I, O) -> Conv2d (O, I, kh, kw);
  * ConvTranspose (kh, kw, I, O) -> ConvTranspose2d (I, O, kh, kw), with the
    spatial flip undone (flax applies the kernel unflipped to the dilated
    input, torch flips it);
  * Dense (I, O) -> Linear (O, I), with or without a bias (the Swin
    blocks' ``merge`` has none);
  * every other leaf (PReLU ``alpha``, the DCN's grouped ``weight`` and
    ``bias``, conv biases, LayerNorm ``scale`` and ``bias``, the Swin
    attention's ``relative_position_bias_table``) is copied as is.

Which rule applies is read from the module that owns the parameter. Every
leaf must be consumed and every parameter of the model filled, each with
its shape checked; anything left over or missing raises.
:func:`params_to_flax` is the reverse map. Both carry any tree shaped like
the parameters, such as AdamW's moments (``mu``, ``nu``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _convert(module: nn.Module, leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return value
    if isinstance(module, nn.ConvTranspose2d):
        return value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if isinstance(module, nn.Conv2d):
        return value.transpose(3, 2, 0, 1)
    if isinstance(module, nn.Linear):
        return value.transpose(1, 0)
    raise ValueError(f"no layout rule for a kernel of {type(module).__name__}")


def _convert_back(module: nn.Module, leaf: str, value: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_convert`."""
    if leaf != "kernel":
        return value
    if isinstance(module, nn.ConvTranspose2d):
        return value[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d):
        return value.transpose(2, 3, 1, 0)
    if isinstance(module, nn.Linear):
        return value.transpose(1, 0)
    raise ValueError(f"no layout rule for a kernel of {type(module).__name__}")


def params_to_flax(tensors: Mapping[str, torch.Tensor], model: nn.Module) -> dict:
    """The flax tree ``{"params": {...}}`` of ``tensors``, a mapping from
    each of ``model``'s parameter names to a tensor of that parameter's
    shape (the parameters themselves, or a moment of the optimizer), as
    float32 numpy arrays in flax's layout, keys sorted at every level as
    flax writes them. Every parameter must be given, and nothing else."""
    expected = dict(model.named_parameters())
    if set(tensors) != set(expected):
        raise KeyError(f"names differ from the model's parameters: missing "
                       f"{sorted(set(expected) - set(tensors))}, extra "
                       f"{sorted(set(tensors) - set(expected))}")
    modules = dict(model.named_modules())
    flat = {}
    for key, value in tensors.items():
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key!r}: shape {tuple(value.shape)}, expected "
                             f"{tuple(expected[key].shape)}")
        owner, _, leaf = key.rpartition(".")
        module = modules[owner]
        if leaf == "weight" and isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            leaf = "kernel"
        arr = value.detach().to("cpu", torch.float32).numpy()
        flat[(*owner.split("."), leaf) if owner else (leaf,)] = np.ascontiguousarray(
            _convert_back(module, leaf, arr))
    tree: dict = {}
    for path in sorted(flat):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = flat[path]
    return {"params": tree}


def params_from_flax(tree: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """Build ``model``'s ``state_dict`` from a flax parameter tree.

    Args:
      tree: ``{"params": {...}}`` (a TrainState's ``params`` field, as
        :func:`..train.read_flax_msgpack` returns it) or the bare tree.
      model: the port's module whose parameter names mirror the flax tree.
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    expected = model.state_dict()
    modules = dict(model.named_modules())
    out = {}
    for path, value in _flatten(tree).items():
        owner, _, leaf = path.rpartition(".")
        key = path if leaf != "kernel" else f"{owner}.weight" if owner else "weight"
        if key not in expected:
            raise KeyError(f"flax leaf {path!r} has no counterpart {key!r}")
        if owner not in modules:
            raise KeyError(f"flax leaf {path!r}: no module {owner!r}")
        arr = _convert(modules[owner], leaf, value)
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"{path!r}: shape {arr.shape} after layout, "
                             f"expected {tuple(expected[key].shape)}")
        out[key] = torch.tensor(np.ascontiguousarray(arr), dtype=expected[key].dtype)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"parameters missing from the flax tree: {missing}")
    return out
