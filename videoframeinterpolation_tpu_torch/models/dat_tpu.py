"""DAT-TPU (counterpart of ``videoframeinterpolation_tpu/models/dat_tpu.py:DATwConstantnCTPU``).

The flagship's skeleton (:class:`.dat.CoarseToFineDAT`: encoder, query
builder, flow pyramid, generator) with each deformable attention level
replaced by :class:`..nn.LocalWindowCrossAttentionBlock`: dense windows of
the flow-warped features (radii 2/2/3 at levels 3/2/1 by default, or the
dilated per-axis taps of ``offset_sets``), optionally re-aligned per
channel group by learned offsets (``n_offset_groups``, offset scales
2/4/8). It launches no deformable sampler. Its loss is the flagship's,
:func:`dat_tpu_loss` = :func:`.dat.dat_loss`.
"""

from __future__ import annotations

import torch

from ..nn import LocalWindowCrossAttentionBlock
from .dat import CoarseToFineDAT, dat_loss


class DATwConstantnCTPU(CoarseToFineDAT):
    def __init__(self, nf: int = 72, enc_res_blocks: int = 5, dec_res_blocks: int = 10,
                 mlp_ratio: float = 2.0, radii: tuple = (2, 2, 3),
                 offset_sets: tuple | None = None, n_offset_groups: tuple = (0, 0, 0),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(nf, enc_res_blocks, dec_res_blocks, compute_dtype)
        r3, r2, r1 = radii
        o3, o2, o1 = offset_sets if offset_sets is not None else (None, None, None)
        g3, g2, g1 = n_offset_groups
        self.dat_lv3 = LocalWindowCrossAttentionBlock(
            nf, nf, radius=r3, n_heads=4, mlp_ratio=mlp_ratio, offsets_1d=o3,
            n_offset_groups=g3, offset_scale=2.0)
        self.dat_lv2 = LocalWindowCrossAttentionBlock(
            nf, nf, radius=r2, n_heads=8, mlp_ratio=mlp_ratio, offsets_1d=o2,
            n_offset_groups=g2, offset_scale=4.0)
        self.dat_lv1 = LocalWindowCrossAttentionBlock(
            nf, nf, radius=r1, n_heads=8, mlp_ratio=mlp_ratio, pred_res_flow=False,
            offsets_1d=o1, n_offset_groups=g1, offset_scale=8.0)


dat_tpu_loss = dat_loss
