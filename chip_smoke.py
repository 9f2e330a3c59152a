#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, each followed by a ``{"phase": ..., "seconds": ...}`` line:

  0. device: exit non-zero when there is no CUDA device; print the card's
     name and power limit as ``nvidia-smi`` reports them;
  1. build: compile ``videoframeinterpolation_tpu_torch/kernels/csrc/*.cu``
     with one ``nvcc`` call and load it with ctypes; print each kernel's
     registers and spills as ``ptxas -v`` reports them;
  2. kernel: every kernel against its plain PyTorch version on the card:
     the deformable sampler at the three DAT level shapes of a 448x256
     request (B2 2) and of a held-out evaluation batch (8 pairs of
     128x128, B2 16) for the shared-offset student (G 1, S 8/8/2), the
     non-shared checkpoint (G 4/8/8, S 8/16/32) and the teacher (G 1, S
     8/16/8), and at edge cases (far, integer,
     edge and negative positions, narrow groups, an odd group width, feat
     misaligned by a storage offset), in fp32 (max |diff| 0.0) and in bf16
     (0 ulps from the fp32 sampling of its bf16 inputs, rounded once); at
     each case the vector width and index width the wrapper picks, and
     every narrower width and the 64-bit index, so that every instance of
     the kernel runs; and a 1080p non-shared level whose output has more
     than 2^31 elements (64-bit indices), checked at its first and last
     (frame, sample) slices; the row and lane gathers at every shape of
     their probes and at an odd shape (equal, max |diff| 0); the row
     gather also at ``ROW_CASES`` (the largest probe shape in bf16, ragged
     rows, x and idx one element off alignment, K = 8M, a table of 60000
     rows) on 32- and 64-bit indices (``torch.equal``), and at an index of
     more than 2^31 elements on 64-bit indices; it fails if any instance
     never ran;
  3. serve: the shipped DAT_fast student at full width, in the bf16 of its
     YAML, answers four 448x256 requests and one 270x480 request through
     the serving entry point, with exactly 3 bf16 sampler launches each;
  4. cpu: one 448x256 request on the card against the same model on the
     CPU (plain path): in fp32 (a float32 config), max |diff| <= 1e-3 on the
     [0, 1] frame; in bf16, mean |diff| at most half the CPU's own gap
     between its bf16 and fp32 frames, the limit the CPU parity test with
     JAX sets;
  5. times: ms/frame at 448x256 in bf16 and in fp32 and, per DAT level
     of every shape of phase 2's level sets
     (``tools/perf/sampler_probe.py``), the sampler's time beside its
     bound, its plain version's time and F.grid_sample's time;
  6. gather: the two gather probes
     (``videoframeinterpolation_tpu_torch.tools.perf.gather_probe`` and
     ``.lane_gather_probe``) at every shape: one checked launch each,
     times beside the bound, the plain version and ``torch.gather``;
  7. checkpoints: ``DAT`` and ``DAT_fast_teacher`` load their committed
     checkpoints and serve four 448x256 requests each in bf16 through
     ``load_model``/``interp_pair``, with exactly 3 bf16 sampler launches
     each; one request card against CPU as in phase 4; ms/frame in bf16;
  8. modes: the student in bf16 at 448x256: ``multi_t_apply`` at t = 1/4,
     1/2, 3/4 equal to the per-instant forward bit for bit
     (``torch.equal``), one encoder run (which launches no sampler) and 3
     bf16 launches per instant; the CLI's recursive and direct modes at
     factor 4 on a 3-frame ``.npy`` sequence write 9 frames each;
  9. eval: ``tools/eval_best.py``'s ``evaluate`` on the card in fp32 for
     the three checkpoints (32 scenes, 128x128, seed 42): each PSNR within
     0.005 dB and each SSIM within 5e-5 of the JAX package's CPU fp32 read
     (``JAX_CPU_FP32``), with 12 fp32 sampler launches per checkpoint; the
     TPU's record in ``eval_best.jsonl`` is printed beside it.

Each path's sampler launches are counted from 0 just before it runs and
read just after; the kernels line gives them per path.

The serving entry point's ``load_model`` switches TF32 off (cuDNN
convolutions and matmuls), so an fp32 model computes in full fp32 on the
card, and phases 4 and 7 compare like with like; the evaluation switches
it off too, for the SSIM's ``conv3d``.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
_T0 = time.perf_counter()

SAMPLER_TOL = 0.0   # the sampler repeats the plain version's fp32 arithmetic step for step
E2E_TOL = 1e-3
BF16_GAP_SHARE = 0.5   # card vs CPU in bf16: at most this share of bf16's own gap
H, W = 256, 448
ODD_TABLE = ((999, 77, torch.bfloat16),)   # (M, N, dtype) beside the probes' shapes
# Row gather cases beyond the probes' shapes, name -> (M, N, K, dtype,
# storage offset of x and idx in elements): the largest probe shape in
# bf16, rows of 77 elements, x and idx at an offset of one element, eight
# index rows per table row, and a table of 60000 rows.
ROW_CASES = {
    "probe_28672_bf16": (28672, 128, 28677, torch.bfloat16, 0),
    "ragged_n77_fp32": (999, 77, 1004, torch.float32, 0),
    "ragged_n77_bf16": (999, 77, 1004, torch.bfloat16, 0),
    "offset1_fp32": (1000, 128, 1005, torch.float32, 1),
    "offset1_bf16": (1000, 128, 1005, torch.bfloat16, 1),
    "k8m_fp32": (1024, 128, 8192, torch.float32, 0),
    "k8m_bf16": (1024, 128, 8192, torch.bfloat16, 0),
    "m60000_fp32": (60000, 128, 60005, torch.float32, 0),
}
# Phase 9: the JAX package's CPU fp32 read of each committed checkpoint on
# the held-out pool (32 scenes, 128x128, seed 42), (PSNR dB, SSIM) as
# ``tools/quality/eval_best.py`` prints them, taken with
#   JAX_PLATFORMS=cpu python tools/quality/eval_best.py --ckpt <ckpt> [...] --out <file>
JAX_CPU_FP32 = {
    # --ckpt tools/quality/results/
    #     DATwConstantnCv1_shared_s8-8-2_distill1.0T8-16-8_24k.best.ckpt --shared --samples 8,8,2
    "DAT_fast": (39.0314, 0.98187),
    # --ckpt tools/quality/results/DATwConstantnCv1_24k.best.ckpt
    "DAT": (37.9723, 0.97841),
    # --ckpt configs/teachers/DATwConstantnCv1_shared_s8-16-8.best.ckpt --shared --samples 8,16,8
    "DAT_fast_teacher": (38.0076, 0.97963),
}
EVAL_PSNR_TOL = 0.005
EVAL_SSIM_TOL = 5e-5
# The same checkpoints as read on a TPU (tools/quality/results/eval_best.jsonl
# lines 8, 7 and 6): printed beside the card's read as history, not held.
TPU_EVAL_BEST = {"DAT_fast": (39.0322, 0.98176), "DAT": (37.9752, 0.97795),
                 "DAT_fast_teacher": (38.009, 0.97946)}
# An index of K x N >= 2^31 elements (64-bit indices): 2^24 + 1 rows of a
# 1024-row bf16 table, checked at its first and last rows.
ROW_WIDE = (1024, 128, 2 ** 24 + 1, torch.bfloat16)
# The non-shared lv1 of a 1920x1080 request (padded to 1088x1920): its
# 2.4e9 output elements need 64-bit indices.
WIDE = (2, 544, 960, 72, 8, 32, 8.0)


def emit(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        emit(f"== phase {self.name} (elapsed {time.perf_counter() - _T0:.1f} s)")
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            emit({"phase": self.name, "seconds": round(time.perf_counter() - self.t, 3)})
        return False


def sampler_cases(gen, level_inputs, level_sets):
    """name -> (feat, flow, residual, storage offset of feat in elements), fp32
    on the card: the level shapes, then inputs whose sample positions or
    widths hit the sampler's edge conditions."""
    cases = {f"{kind}_{name}": (*level_inputs(gen, B2, h, w, 72, G, S, sc), 0)
             for kind, levels in level_sets.items() for name, B2, h, w, G, S, sc in levels}
    B2, h, w, C, S = 2, 32, 56, 72, 8
    feat, flow, res = level_inputs(gen, B2, h, w, C, 1, S, 2.0)
    gy, gx = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float32),
                            torch.arange(w, device="cuda", dtype=torch.float32),
                            indexing="ij")
    base = torch.stack([gx, gy], -1)[None]
    frac = torch.rand((B2, h, w, 1, S, 2), generator=gen, device="cuda")
    far = torch.randn((B2, h, w, 2), generator=gen, device="cuda") * 1e4
    integer = torch.round(torch.randn((B2, h, w, 2), generator=gen, device="cuda") * 3)
    last = torch.tensor([w - 1.0, h - 1.0], device="cuda") - base
    neg = -base - 1.5
    cases.update({
        "far_outside": (feat, far.contiguous(), res, 0),
        "on_integers": (feat, integer.contiguous(), torch.round(res), 0),
        "last_row_col": (feat, last.expand(B2, h, w, 2).contiguous(),
                         torch.where(frac < 0.25, 0.0, frac - 0.5), 0),
        "negative": (feat, neg.expand(B2, h, w, 2).contiguous(), frac * 2.0, 0),
        "groups4_cg18": (*level_inputs(gen, B2, h, w, C, 4, S, 2.0), 0),
        "groups8_cg9": (*level_inputs(gen, 1, 9, 13, 72, 8, 3, 30.0), 0),
        "odd_c40_g8": (*level_inputs(gen, 1, 9, 13, 40, 8, 3, 30.0), 0),
        "c40_g1": (*level_inputs(gen, 1, 9, 13, 40, 1, 3, 30.0), 0),
        "odd_cg7": (*level_inputs(gen, 2, 11, 17, 21, 3, 5, 3.0), 0),
    })
    for offset in (1, 2, 4):
        cases[f"misaligned_by_{offset}"] = (feat, flow, res, offset)
    return cases


def at_offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``offset`` elements into a
    larger buffer, so that its data pointer is aligned to that offset only."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def main() -> int:
    with Phase("device"):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
                  "nothing was run", file=sys.stderr, flush=True)
            return 1
        kind = torch.cuda.get_device_name(0)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], check=True, capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
        emit(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
        emit(card)

    sys.path.insert(0, str(ROOT))
    from videoframeinterpolation_tpu_torch.config import DAT_fast, PRESETS
    from videoframeinterpolation_tpu_torch.interpolate import SHIPPED_STUDENT, load_model
    from videoframeinterpolation_tpu_torch.kernels import (
        build, lane_gather, lane_gather_plain, row_gather, row_gather_plain)
    from videoframeinterpolation_tpu_torch.kernels.window_sample import (
        _grouped_deformable_sample, _index_bits, _launch, _vector_bytes, deformable_sample)
    from videoframeinterpolation_tpu_torch.tools.perf import (
        gather_probe, lane_gather_probe, sampler_probe, timing)

    with Phase("build"):
        nvcc = build.find_nvcc()
        emit(f"nvcc {nvcc}: {build.nvcc_release(nvcc)}")
        t = time.perf_counter()
        build.load_library()
        emit({"build_seconds": round(time.perf_counter() - t, 3), "nvcc": nvcc,
              "sources": [str(p.relative_to(ROOT)) for p in build.sources()]})
        for row in build.ptxas_report():
            emit({"ptxas": row})

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {}
    with Phase("kernel"):
        # The sampler in fp32 must equal its plain version; in bf16 it takes
        # res + flow in fp32 (as the plain version does), samples in fp32
        # and rounds once, so it must equal the fp32 sampling of the same
        # bf16 inputs, rounded once (0 bf16 ulps). For fp32 inputs this
        # reference is the plain version itself.
        def sampler_ref(feat, flow, res):
            ref = _grouped_deformable_sample(
                feat.float(), res.float() + flow.float()[:, :, :, None, None, :], res.shape[3])
            return ref.to(feat.dtype).float()

        reached = set()
        cases = sampler_cases(gen, sampler_probe.level_inputs, sampler_probe.LEVEL_SETS)
        for name, (feat32, flow32, res32, offset) in cases.items():
            for dtype in (torch.float32, torch.bfloat16):
                feat = at_offset(feat32.to(dtype), offset)
                flow, res = flow32.to(dtype), res32.to(dtype)
                B2, h, w, C = feat.shape
                G, S = res.shape[3], res.shape[4]
                ref = sampler_ref(feat, flow, res)
                out = deformable_sample(feat, flow, res, G)
                torch.cuda.synchronize()
                plan = (_vector_bytes(C, G, feat.element_size(), feat.data_ptr(),
                                      out.data_ptr()), _index_bits(B2, h, w, C, G, S))
                # Every narrower width and the 64-bit index on the same inputs.
                checked = {plan: out}
                width = plan[0]
                while width >= feat.element_size():
                    for bits in (32, 64):
                        if (width, bits) not in checked:
                            checked[width, bits] = _launch(feat, flow, res, G, width, bits)
                    width //= 2
                torch.cuda.synchronize()
                for (width, bits), got in checked.items():
                    err = (got.float() - ref).abs().max().item()
                    reached.add((str(dtype), width, bits))
                    if not err <= SAMPLER_TOL:
                        raise AssertionError(f"sampler vs reference, case {name} {dtype} "
                                             f"V={width} {bits}-bit: {err} > {SAMPLER_TOL}")
                err = (out.float() - ref).abs().max().item()
                max_err["deformable_sample"] = max(max_err.get("deformable_sample", 0.0), err)
                emit({"case": name, "dtype": str(dtype), "shape": list(res.shape),
                      "feat_offset_bytes": feat.data_ptr() % 16, "vector_bytes": plan[0],
                      "index_bits": plan[1], "instances": sorted(checked), "max_abs_err": err,
                      **({"max_err_in_ulps": bf16_ulps(out.float(), ref)}
                         if dtype == torch.bfloat16 else {})})
            del feat, flow, res, ref, out, checked
        # 64-bit indices, as the wrapper picks them: the first and last
        # (frame, sample) slices against the reference on those slices.
        B2, h, w, C, G, S, sc = WIDE
        wide = sampler_probe.level_inputs(gen, B2, h, w, C, G, S, sc)
        for dtype in (torch.bfloat16, torch.float32):
            feat, flow, res = (x.to(dtype) for x in wide)
            out = deformable_sample(feat, flow, res, G)
            torch.cuda.synchronize()
            bits = _index_bits(B2, h, w, C, G, S)
            finite = bool(torch.isfinite(out).all())
            errs = []
            for b, s_ in ((0, 0), (B2 - 1, S - 1)):
                ref = sampler_ref(feat[b:b + 1], flow[b:b + 1], res[b:b + 1, :, :, :, s_:s_ + 1])
                errs.append((out[b:b + 1, s_:s_ + 1].float() - ref).abs().max().item())
            reached.add((str(dtype), "wide", bits))
            emit({"case": "wide_index_1080p_non_shared_lv1", "dtype": str(dtype),
                  "shape": list(res.shape), "out_elements": out.numel(), "index_bits": bits,
                  "finite": finite, "max_abs_err_first_last_slices": errs})
            if bits != 64 or not finite or max(errs) > SAMPLER_TOL:
                raise AssertionError(f"wide sampler case {dtype}: {bits}-bit, finite {finite}, "
                                     f"errors {errs}")
            del feat, flow, res, out
        del wide
        need = ({("torch.float32", v, b) for v in (16, 8, 4) for b in (32, 64)}
                | {("torch.bfloat16", v, b) for v in (16, 8, 4, 2) for b in (32, 64)}
                | {("torch.float32", "wide", 64), ("torch.bfloat16", "wide", 64)})
        if need - reached:
            raise AssertionError(f"sampler instances never run: {sorted(need - reached, key=str)}")
        emit({"sampler_paths_checked": len(need), "max_abs_err": max_err["deformable_sample"]})
        torch.cuda.empty_cache()
        for kernel, plain, axis, shapes in (
                (row_gather, row_gather_plain, 0, gather_probe.SHAPES + ODD_TABLE),
                (lane_gather, lane_gather_plain, 1, lane_gather_probe.SHAPES + ODD_TABLE)):
            for M, N, dtype in shapes:
                x = torch.randn((M, N), generator=gen, device="cuda", dtype=dtype)
                # More index rows (row gather) or fewer columns (lane gather)
                # than the table has, to hold the kernels to take_along_axis.
                idx_shape = (M + 5, N) if axis == 0 else (M, N - 3)
                idx = torch.randint(0, (M, N)[axis], idx_shape, generator=gen, device="cuda",
                                    dtype=torch.int32)
                out = kernel(x, idx)
                torch.cuda.synchronize()
                err = (out.float() - plain(x, idx).float()).abs().max().item()
                emit({"case": kernel.__name__, "table": [M, N], "index": list(idx.shape),
                      "dtype": str(dtype), "max_abs_err": err})
                if not (err == 0.0 and torch.equal(out, plain(x, idx))):
                    raise AssertionError(f"{kernel.__name__} vs plain at {M}x{N} {dtype}: {err}")
                max_err[kernel.__name__] = max(max_err.get(kernel.__name__, 0.0), err)
        del x, idx, out
        check_row_gather(gen, gather_probe.SHAPES)

    rng = np.random.default_rng(0)
    tex = smooth_texture(rng, 320, 512)
    shift = (4, 8)   # (dy, dx) between frame 0 and frame 1
    path_launches = {}
    with Phase("serve"):
        model = load_model(DAT_fast, SHIPPED_STUDENT, device="cuda")
        if model.dtype != torch.bfloat16 or DAT_fast.compute_dtype != "bfloat16":
            raise AssertionError(f"DAT_fast served in {model.dtype}, its YAML says bfloat16")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("load_model left TF32 on: an fp32 model would not compute fp32")
        n_params = sum(p.numel() for p in model.parameters())
        emit({"checkpoint": str(SHIPPED_STUDENT.relative_to(ROOT)), "nf": DAT_fast.nf,
              "params": n_params, "dtype": str(model.dtype)})
        requests = [((H, W), 0.5), ((H, W), 0.25), ((H, W), 0.5), ((H, W), 0.25),
                    ((270, 480), 0.5)]
        deformable_sample.launches = deformable_sample.bf16_launches = 0
        serve_requests(model, requests, tex, shift, "DAT_fast")
        path_launches["serve"] = deformable_sample.launches
        emit({"main_path_launches": path_launches["serve"],
              "bf16_launches": deformable_sample.bf16_launches, "requests": len(requests)})

    fp32_cfg = dataclasses.replace(DAT_fast, compute_dtype="float32")
    f0, f1, _ = frames(tex, H, W, shift, 0.5)
    x0, x1 = (torch.from_numpy(f.astype(np.float32) / 255.0)[None] for f in (f0, f1))
    t5 = torch.full((1, 1, 1, 1), 0.5)
    with Phase("cpu"):
        model32 = card_vs_cpu(DAT_fast, SHIPPED_STUDENT, model, x0, x1, t5)

    # The CPU threads of phase 4 would compete with the thread that issues
    # the card's work.
    torch.set_num_threads(1)
    with Phase("times"):
        xs = (x0.cuda(), x1.cuda(), t5.cuda())
        with torch.inference_mode():
            for name, m in (("bf16", model), ("fp32", model32)):
                frame_ms = timing.loop_ms(lambda: m(*xs), 20, warmup=5) / 20
                emit({f"ms_per_frame_448x256_{name}": frame_ms, "card": card})
        del model32
        per_level = sampler_probe.main()
        # The main path's levels: the shared-offset student in bf16.
        shared = list(per_level["shared"]["bfloat16"].values())
        emit({"sampler_speed": {
            "shared_bf16_kernel_over_library": (sum(r["ms"] for r in shared)
                                                / sum(r["library_ms"] for r in shared)),
            "shared_bf16_share_of_bound": (sum(r["bound_ms"] for r in shared)
                                           / sum(r["ms"] for r in shared)),
            "faster_than_library": {f"{kind}_{dtype}_{name}": r["ms"] < r["library_ms"]
                                    for kind, by_dtype in per_level.items()
                                    for dtype, rows in by_dtype.items()
                                    for name, r in rows.items()},
            "card": card}})

    probes = {}
    with Phase("gather"):
        row_gather.launches = lane_gather.launches = 0
        probes["row_gather"] = gather_probe.main()
        probes["lane_gather"] = lane_gather_probe.main()
        gather_launches = {"row_gather": row_gather.launches,
                           "lane_gather": lane_gather.launches}
        emit({"main_path_launches": gather_launches})
        for name, rows in probes.items():
            if gather_launches[name] != len(rows) or not all(r["exact"] for r in rows):
                raise AssertionError(f"{name}: {gather_launches[name]} launches for "
                                     f"{len(rows)} shapes, or a result that is not exact")

    with Phase("checkpoints"):
        for name in ("DAT", "DAT_fast_teacher"):
            cfg, ckpt = PRESETS[name]
            served = load_model(cfg, ckpt, device="cuda")
            emit({"checkpoint": str(ckpt.relative_to(ROOT)), "config": name,
                  "shared_offsets": cfg.shared_offsets, "dat_samples": list(cfg.dat_samples),
                  "params": sum(p.numel() for p in served.parameters()),
                  "dtype": str(served.dtype)})
            deformable_sample.launches = deformable_sample.bf16_launches = 0
            serve_requests(served, [((H, W), 0.5), ((H, W), 0.25)] * 2, tex, shift, name)
            path_launches[f"checkpoints_{name}"] = deformable_sample.launches
            emit({"config": name, "path_launches": deformable_sample.launches,
                  "bf16_launches": deformable_sample.bf16_launches})
            card_vs_cpu(cfg, ckpt, served, x0, x1, t5)
            torch.set_num_threads(1)
            with torch.inference_mode():
                emit({f"ms_per_frame_448x256_bf16_{name}":
                      timing.loop_ms(lambda: served(*xs), 20, warmup=5) / 20, "card": card})
            del served
            torch.cuda.empty_cache()

    with Phase("modes"):
        check_modes(model, tex, shift, path_launches)

    with Phase("eval"):
        check_eval(path_launches)

    def total(rows, key):
        return sum(r[key] for r in rows)

    kernels = [{
        "name": "deformable_sample",
        "route": "cuda",
        "source": "videoframeinterpolation_tpu_torch/kernels/csrc/deformable_sample.cu",
        "replaces": "videoframeinterpolation_tpu/kernels/window_sample.py:158",
        "launches": path_launches["serve"],
        "launches_per_path": path_launches,
        "max_abs_err": max_err["deformable_sample"],
        "ms": total(shared, "ms"),
        "plain_ms": total(shared, "plain_ms"),
        "bound_ms": total(shared, "bound_ms"),
        "bound_by": ("bytes" if total(shared, "bytes_ms") >= total(shared, "ops_ms")
                     else "operations"),
        "library_ms": total(shared, "library_ms"),
        "dtype": "bfloat16",
        "per_level": per_level,
        "card": card,
    }]
    for name, replaces in (("row_gather", "tools/perf/pallas_gather_probe.py:11"),
                           ("lane_gather", "tools/perf/pallas_lane_gather_probe.py:14")):
        rows = probes[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "videoframeinterpolation_tpu_torch/kernels/csrc/gather.cu",
            "replaces": replaces,
            "launches": gather_launches[name],
            "max_abs_err": max(max_err[name], max(r["max_abs_err"] for r in rows)),
            "ms": total(rows, "ms"),
            "plain_ms": total(rows, "plain_ms"),
            "bound_ms": total(rows, "bound_ms"),
            "bound_by": "bytes",
            "library_ms": total(rows, "library_ms"),
            "per_shape": rows,
            "card": card,
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def serve_requests(model, requests, tex, shift, name: str) -> None:
    """Serve each ``((h, w), t)`` request through ``interp_pair``; each must
    give a uint8 ``(h, w, 3)`` frame with exactly 3 bf16 sampler launches."""
    from videoframeinterpolation_tpu_torch.interpolate import interp_pair
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample

    for i, ((h, w), t) in enumerate(requests):
        f0, f1, mid = frames(tex, h, w, shift, t)
        before, before_bf16 = deformable_sample.launches, deformable_sample.bf16_launches
        start = time.perf_counter()
        pred = interp_pair(model, f0, f1, t)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - start) * 1e3
        launched = deformable_sample.launches - before
        launched_bf16 = deformable_sample.bf16_launches - before_bf16
        if pred.shape != (h, w, 3) or pred.dtype != np.uint8:
            raise AssertionError(f"{name} request {i}: got {pred.dtype} {pred.shape}")
        if launched != 3 or launched_bf16 != 3:
            raise AssertionError(f"{name} request {i}: {launched} sampler launches, "
                                 f"{launched_bf16} in bf16; expected 3 bf16")
        emit({"config": name, "request": i, "hw": [h, w], "t": t, "host_ms": round(host_ms, 3),
              "launches": launched, "bf16_launches": launched_bf16,
              "psnr_vs_shifted_mid": round(psnr(pred, mid), 3),
              "psnr_frame0_vs_mid": round(psnr(f0, mid), 3)})


def card_vs_cpu(cfg, ckpt, card_model, x0, x1, t):
    """One request on the card against the same checkpoint on the CPU (plain
    path): an fp32 copy of ``cfg`` within ``E2E_TOL`` max abs, and
    ``card_model`` (``cfg`` in bf16) within ``BF16_GAP_SHARE`` of the CPU's
    own bf16-vs-fp32 gap in mean abs. Returns the fp32 model on the card."""
    from videoframeinterpolation_tpu_torch.interpolate import load_model

    fp32_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    torch.set_num_threads(os.cpu_count() or 1)
    model32 = load_model(fp32_cfg, ckpt, device="cuda")
    with torch.inference_mode():
        on_card = {"float32": model32(x0.cuda(), x1.cuda(), t.cuda()).cpu(),
                   "bfloat16": card_model(x0.cuda(), x1.cuda(), t.cuda()).cpu()}
        cpu, cpu_s = {}, {}
        for c in (fp32_cfg, cfg):
            start = time.perf_counter()
            cpu[c.compute_dtype] = load_model(c, ckpt, device="cpu")(x0, x1, t)
            cpu_s[c.compute_dtype] = round(time.perf_counter() - start, 3)
    shape = (1, *x0.shape[1:])
    for name, out in on_card.items():
        if not (out.dtype == torch.float32 and torch.isfinite(out).all() and out.shape == shape):
            raise AssertionError(f"card output ({name}): {out.dtype} {tuple(out.shape)} "
                                 "or non-finite")
    ckpt_name = Path(ckpt).name
    e2e_err = (on_card["float32"] - cpu["float32"]).abs().max().item()
    emit({"checkpoint": ckpt_name, "fp32_max_abs_err_vs_cpu": e2e_err,
          "mean_abs_err": (on_card["float32"] - cpu["float32"]).abs().mean().item(),
          "tol": E2E_TOL, "cpu_seconds": cpu_s["float32"]})
    if not e2e_err <= E2E_TOL:
        raise AssertionError(f"{ckpt_name}: card vs CPU, fp32: {e2e_err} > {E2E_TOL}")
    bf16_gap = (cpu["bfloat16"] - cpu["float32"]).abs().mean().item()
    bf16_err = (on_card["bfloat16"] - cpu["bfloat16"]).abs().mean().item()
    emit({"checkpoint": ckpt_name, "bf16_mean_abs_err_vs_cpu": bf16_err,
          "max_abs_err": (on_card["bfloat16"] - cpu["bfloat16"]).abs().max().item(),
          "cpu_bf16_vs_fp32_mean_abs": bf16_gap, "limit": BF16_GAP_SHARE * bf16_gap,
          "share_of_gap": bf16_err / bf16_gap, "cpu_seconds": cpu_s["bfloat16"]})
    if not bf16_err <= BF16_GAP_SHARE * bf16_gap:
        raise AssertionError(f"{ckpt_name}: card vs CPU, bf16: mean {bf16_err} > "
                             f"{BF16_GAP_SHARE} x {bf16_gap}")
    return model32


def check_modes(model, tex, shift, path_launches: dict) -> None:
    """Multi-instant serving of the student in bf16 at 448x256: the frames
    of ``multi_t_apply`` at t = 1/4, 1/2, 3/4 equal the per-instant forward
    bit for bit, with one encoder run and 3 bf16 sampler launches per
    instant (the encoder launches none); then the CLI's recursive and direct
    modes at factor 4 on a 3-frame ``.npy`` sequence write 9 frames each."""
    from videoframeinterpolation_tpu_torch import interpolate
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample
    from videoframeinterpolation_tpu_torch.models import multi_t_apply

    f0, f1, _ = frames(tex, H, W, shift, 0.5)
    x0, x1 = (torch.from_numpy(f.astype(np.float32) / 255.0)[None].cuda() for f in (f0, f1))
    ts = (0.25, 0.5, 0.75)
    with torch.inference_mode():
        deformable_sample.launches = deformable_sample.bf16_launches = 0
        model.encode(x0, x1)
        encoder_launches = deformable_sample.launches
        encodes = []
        encode = model.encode
        model.encode = lambda a, b: (encodes.append(1), encode(a, b))[1]
        try:
            deformable_sample.launches = deformable_sample.bf16_launches = 0
            direct = multi_t_apply(model, x0, x1, ts)
            torch.cuda.synchronize()
            launched, launched_bf16 = deformable_sample.launches, deformable_sample.bf16_launches
        finally:
            del model.encode
        path_launches["modes_multi_t"] = launched
        singles = [model(x0, x1, torch.full((1, 1, 1, 1), t, device="cuda")) for t in ts]
        torch.cuda.synchronize()
    equal = [bool(torch.equal(direct[k], s)) for k, s in enumerate(singles)]
    emit({"multi_t_apply": {"ts": list(ts), "shape": list(direct.shape),
                            "equal_to_per_t_forward": equal, "encoder_runs": len(encodes),
                            "encoder_launches": encoder_launches, "launches": launched,
                            "bf16_launches": launched_bf16,
                            "max_abs_diff": max((direct[k] - s).abs().max().item()
                                                for k, s in enumerate(singles))}})
    if not all(equal):
        raise AssertionError(f"multi_t_apply differs from the per-t forward: {equal}")
    if encoder_launches or len(encodes) != 1 or (launched, launched_bf16) != (9, 9):
        raise AssertionError(f"multi_t_apply: {len(encodes)} encoder runs, encoder launches "
                             f"{encoder_launches}, {launched} launches ({launched_bf16} bf16); "
                             "expected 1, 0 and 9 bf16")

    with tempfile.TemporaryDirectory() as tmp:
        in_dir = Path(tmp) / "in"
        in_dir.mkdir()
        for i in range(3):
            np.save(in_dir / f"{i:03d}.npy", frames(tex, H, W, (i * shift[0], i * shift[1]),
                                                    0.0)[1])
        for mode in ("recursive", "direct"):
            out_dir = Path(tmp) / mode
            deformable_sample.launches = deformable_sample.bf16_launches = 0
            interpolate.main(["--in_dir", str(in_dir), "--out_dir", str(out_dir),
                              "--factor", "4", "--mode", mode, "--device", "cuda"])
            torch.cuda.synchronize()
            written = sorted(p.name for p in out_dir.iterdir())
            shapes = {np.load(out_dir / n).shape for n in written}
            path_launches[f"modes_cli_{mode}"] = deformable_sample.launches
            emit({"cli_mode": mode, "factor": 4, "frames_in": 3, "frames_out": len(written),
                  "shapes": sorted(shapes), "launches": deformable_sample.launches,
                  "bf16_launches": deformable_sample.bf16_launches})
            if written != [f"{i:06d}.npy" for i in range(9)] or shapes != {(H, W, 3)}:
                raise AssertionError(f"--mode {mode} --factor 4 wrote {written} of {shapes}")
            if deformable_sample.bf16_launches != 18:
                raise AssertionError(f"--mode {mode}: {deformable_sample.bf16_launches} bf16 "
                                     "sampler launches; expected 18 (6 frames, 3 each)")


def check_eval(path_launches: dict) -> None:
    """The held-out evaluation of every committed checkpoint on the card in
    fp32 (32 scenes, 128x128, seed 42): each PSNR within ``EVAL_PSNR_TOL``
    dB and each SSIM within ``EVAL_SSIM_TOL`` of the JAX package's CPU fp32
    read (``JAX_CPU_FP32``); the TPU's record is printed beside it."""
    from videoframeinterpolation_tpu_torch.config import PRESETS
    from videoframeinterpolation_tpu_torch.kernels import deformable_sample
    from videoframeinterpolation_tpu_torch.tools.eval_best import evaluate

    for name, (ref_psnr, ref_ssim) in JAX_CPU_FP32.items():
        cfg, ckpt = PRESETS[name]
        deformable_sample.launches = deformable_sample.bf16_launches = 0
        start = time.perf_counter()
        (rec,) = evaluate(cfg, [ckpt], eval_items=32, crop=128, seed=42, device="cuda")
        seconds = time.perf_counter() - start
        path_launches[f"eval_{name}"] = deformable_sample.launches
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("the evaluation left TF32 on")
        tpu_psnr, tpu_ssim = TPU_EVAL_BEST[name]
        emit({"eval": name, "checkpoint": str(ckpt.relative_to(ROOT)), "step": rec["step"],
              "n": rec["n"], "psnr": rec["psnr"], "ssim": rec["ssim"],
              "jax_cpu_fp32": {"psnr": ref_psnr, "ssim": ref_ssim},
              "psnr_minus_jax_cpu": rec["psnr"] - ref_psnr,
              "ssim_minus_jax_cpu": rec["ssim"] - ref_ssim,
              "tpu_eval_best_jsonl": {"psnr": tpu_psnr, "ssim": tpu_ssim,
                                      "psnr_minus_tpu": rec["psnr"] - tpu_psnr,
                                      "ssim_minus_tpu": rec["ssim"] - tpu_ssim},
              "launches": deformable_sample.launches,
              "bf16_launches": deformable_sample.bf16_launches, "seconds": round(seconds, 3)})
        if rec["n"] != 32 or deformable_sample.launches != 12 or deformable_sample.bf16_launches:
            raise AssertionError(f"eval {name}: {rec['n']} items, {deformable_sample.launches} "
                                 f"launches ({deformable_sample.bf16_launches} bf16); expected "
                                 "32 items and 12 fp32 launches (4 batches of 8, 3 each)")
        if not (abs(rec["psnr"] - ref_psnr) <= EVAL_PSNR_TOL
                and abs(rec["ssim"] - ref_ssim) <= EVAL_SSIM_TOL):
            raise AssertionError(f"eval {name}: PSNR {rec['psnr']} / SSIM {rec['ssim']} against "
                                 f"JAX's CPU fp32 {ref_psnr} / {ref_ssim}")

def check_row_gather(gen, probe_shapes) -> None:
    """The row gather at the probes' shapes (K = M + 5) and ``ROW_CASES``,
    through the wrapper and then on the same inputs at both index widths;
    and ``ROW_WIDE`` on the wrapper's 64-bit indices. Each result must
    equal the plain version exactly (``torch.equal``); raises if any
    (dtype, index width) instance never ran."""
    from videoframeinterpolation_tpu_torch.kernels import row_gather, row_gather_plain
    from videoframeinterpolation_tpu_torch.kernels.gather import (
        _row_gather_launch, _row_index_bits)

    cases = {f"probe_{M}": (M, N, M + 5, dtype, 0) for M, N, dtype in probe_shapes}
    cases.update(ROW_CASES)
    reached = set()
    for name, (M, N, K, dtype, offset) in cases.items():
        x = at_offset(torch.randn((M, N), generator=gen, device="cuda").to(dtype), offset)
        idx = at_offset(torch.randint(0, M, (K, N), generator=gen, device="cuda",
                                      dtype=torch.int32), offset)
        ref = row_gather_plain(x, idx)
        for bits in (None, 32, 64):
            got = row_gather(x, idx) if bits is None else _row_gather_launch(x, idx, bits)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"row gather vs plain, case {name}, index bits {bits}")
            reached.add((str(dtype), bits or _row_index_bits(M, N, K)))
        emit({"case": "row_gather", "name": name, "table": [M, N], "index": [K, N],
              "dtype": str(dtype), "x_offset_bytes": x.data_ptr() % 16,
              "index_bits": _row_index_bits(M, N, K), "max_abs_err": 0.0})
        del x, idx, ref, got
    torch.cuda.empty_cache()
    M, N, K, dtype = ROW_WIDE
    x = torch.randn((M, N), generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, M, (K, N), generator=gen, device="cuda", dtype=torch.int32)
    out = row_gather(x, idx)
    torch.cuda.synchronize()
    bits = _row_index_bits(M, N, K)
    ends = all(torch.equal(out[rows], row_gather_plain(x, idx[rows]))
               for rows in (slice(0, 1), slice(K - 1, K)))
    emit({"case": "row_gather_wide_index", "table": [M, N], "index": [K, N],
          "elements": K * N, "dtype": str(dtype), "index_bits": bits,
          "first_last_rows_equal": ends})
    if bits != 64 or not ends:
        raise AssertionError(f"row gather, {K * N} index elements, {bits}-bit indices: "
                             f"first and last rows equal: {ends}")
    reached.add((str(dtype), "wide", 64))
    del x, idx, out
    torch.cuda.empty_cache()
    need = ({(dt, b) for dt in ("torch.float32", "torch.bfloat16") for b in (32, 64)}
            | {("torch.bfloat16", "wide", 64)})
    if need - reached:
        raise AssertionError(f"row gather instances never run: {sorted(need - reached, key=str)}")
    emit({"row_gather_instances_checked": len(need)})


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest ``|out - ref|`` in units of the bf16 spacing at
    ``max(|out|, |ref|)`` (8 significant bits)."""
    mag = torch.maximum(out.abs(), ref.abs())
    _, exp = torch.frexp(mag)   # mag = m * 2**exp with m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(mag), exp - 8).clamp_min(2.0 ** -133)
    return ((out - ref).abs() / ulp).max().item()


def smooth_texture(rng, h: int, w: int) -> np.ndarray:
    """A smooth random RGB texture in [0, 1]: bilinear upsampling of coarse noise."""
    coarse = torch.from_numpy(rng.random((1, 3, h // 16 + 2, w // 16 + 2), dtype=np.float32))
    fine = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)
    return fine[0].permute(1, 2, 0).numpy()


def frames(tex: np.ndarray, h: int, w: int, shift, t: float):
    """Frame 0, frame 1 shifted by ``shift`` pixels, and the texture shifted
    by ``t * shift`` (the ideal frame at ``t``), all uint8 ``(h, w, 3)``."""
    dy, dx = shift
    y, x = 8, 8

    def crop(oy, ox):
        return (tex[y + oy:y + oy + h, x + ox:x + ox + w] * 255).astype(np.uint8)

    return crop(0, 0), crop(dy, dx), crop(round(t * dy), round(t * dx))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


if __name__ == "__main__":
    sys.exit(main())
