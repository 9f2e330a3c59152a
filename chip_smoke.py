#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, each followed by a ``{"phase": ..., "seconds": ...}`` line:

  0. device: exit non-zero when there is no CUDA device; print the card's
     name and power limit as ``nvidia-smi`` reports them;
  1. build: compile ``videoframeinterpolation_tpu_torch/kernels/csrc/*.cu``
     with one ``nvcc`` call and load it with ctypes;
  2. kernel: the deformable sampler kernel against its plain PyTorch
     version on the card, at the three DAT level shapes of a 448x256
     request and at edge cases (max |diff| <= 1e-5 in fp32);
  3. serve: the shipped DAT_fast student at full width answers four
     448x256 requests and one 270x480 request through the serving entry
     point, with exactly 3 sampler launches per request;
  4. cpu: one 448x256 request on the card (kernel path) against the same
     model on the CPU (plain path), max |diff| <= 1e-3 on the [0, 1] frame;
  5. times: ms/frame at 448x256 and, per DAT level, the kernel's time
     beside its bound, its plain version's time and F.grid_sample's time.

The serving entry point's ``load_model`` switches TF32 off (cuDNN
convolutions and matmuls), so the card computes in full fp32, as the CLI
serves, and phase 4 compares like with like.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
_T0 = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = 1e-5
E2E_TOL = 1e-3
H, W = 256, 448
# (name, H, W, S, offset_scale) of the three DAT levels at 448x256, G = 1.
LEVELS = (("lv3", 32, 56, 8, 2.0), ("lv2", 64, 112, 8, 4.0), ("lv1", 128, 224, 2, 8.0))


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


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def level_inputs(gen, B2, h, w, C, G, S, scale, flow_mag=4.0):
    feat = torch.randn((B2, h, w, C), generator=gen, device="cuda")
    flow = torch.randn((B2, h, w, 2), generator=gen, device="cuda") * flow_mag
    res = scale * torch.tanh(torch.randn((B2, h, w, G, S, 2), generator=gen, device="cuda"))
    return feat, flow, res


def edge_cases(gen):
    """Inputs whose sample positions hit the sampler's edge conditions."""
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
    cases = {
        "far_outside": (feat, far.contiguous(), res),
        "on_integers": (feat, integer.contiguous(), torch.round(res)),
        "last_row_col": (feat, last.expand(B2, h, w, 2).contiguous(),
                         torch.where(frac < 0.25, 0.0, frac - 0.5)),
        "negative": (feat, neg.expand(B2, h, w, 2).contiguous(), frac * 2.0),
        "groups4_cg18": level_inputs(gen, B2, h, w, C, 4, S, 2.0),
    }
    return cases


def main() -> int:
    with Phase("device"):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
                  "nothing was run", file=sys.stderr, flush=True)
            return 1
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True).stdout.strip().splitlines()[0]
        card = smi
        emit(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
        emit(smi)

    sys.path.insert(0, str(ROOT))
    from videoframeinterpolation_tpu_torch.config import DAT_fast
    from videoframeinterpolation_tpu_torch.interpolate import (
        SHIPPED_STUDENT, interp_pair, load_model)
    from videoframeinterpolation_tpu_torch.kernels import build
    from videoframeinterpolation_tpu_torch.kernels.window_sample import (
        _grouped_deformable_sample, deformable_sample, deformable_sample_plain)

    with Phase("build"):
        nvcc = build.find_nvcc()
        emit(f"nvcc {nvcc}: {build.nvcc_release(nvcc)}")
        t = time.perf_counter()
        build.load_library()
        emit({"build_seconds": round(time.perf_counter() - t, 3), "nvcc": nvcc,
              "sources": [str(p.relative_to(ROOT)) for p in build.sources()]})

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    with Phase("kernel"):
        cases = {name: level_inputs(gen, 2, h, w, 72, 1, S, sc)
                 for name, h, w, S, sc in LEVELS}
        cases.update(edge_cases(gen))
        for name, (feat, flow, res) in cases.items():
            out = deformable_sample(feat, flow, res, res.shape[3])
            torch.cuda.synchronize()
            ref = deformable_sample_plain(feat, flow, res, res.shape[3])
            err = (out - ref).abs().max().item()
            emit({"case": name, "shape": list(res.shape), "max_abs_err": err})
            if not err <= KERNEL_TOL:
                raise AssertionError(f"kernel vs plain, case {name}: {err} > {KERNEL_TOL}")
            max_err = max(max_err, err)
        # bf16 dispatch: the kernel adds res + flow in bf16 and samples in
        # fp32, so the reference does the same and rounds once at the end;
        # the two may differ by one bf16 ulp (2^-7 relative).
        feat, flow, res = (x.bfloat16() for x in cases["lv3"])
        out = deformable_sample(feat, flow, res, 1).float()
        ref = _grouped_deformable_sample(
            feat.float(), (res + flow[:, :, :, None, None, :]).float(), 1).bfloat16().float()
        ulps = ((out - ref).abs() / (ref.abs() * 2.0 ** -7 + 1e-30)).max().item()
        emit({"case": "lv3_bf16", "max_abs_err": (out - ref).abs().max().item(),
              "max_err_in_ulps": ulps})
        if not ulps <= 1.0:
            raise AssertionError(f"bf16 kernel vs reference: {ulps} ulps > 1")

    rng = np.random.default_rng(0)
    tex = smooth_texture(rng, 320, 512)
    shift = (4, 8)   # (dy, dx) between frame 0 and frame 1
    with Phase("serve"):
        model = load_model(DAT_fast, SHIPPED_STUDENT, device="cuda")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("load_model left TF32 on: the card would not serve fp32")
        n_params = sum(p.numel() for p in model.parameters())
        emit({"checkpoint": str(SHIPPED_STUDENT.relative_to(ROOT)), "nf": DAT_fast.nf,
              "params": n_params})
        requests = [((H, W), 0.5), ((H, W), 0.25), ((H, W), 0.5), ((H, W), 0.25),
                    ((270, 480), 0.5)]
        deformable_sample.launches = 0
        for i, ((h, w), t) in enumerate(requests):
            f0, f1, mid = frames(tex, h, w, shift, t)
            before = deformable_sample.launches
            start = time.perf_counter()
            pred = interp_pair(model, f0, f1, t)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - start) * 1e3
            launched = deformable_sample.launches - before
            if pred.shape != (h, w, 3) or pred.dtype != np.uint8:
                raise AssertionError(f"request {i}: got {pred.dtype} {pred.shape}")
            if launched != 3:
                raise AssertionError(f"request {i}: {launched} sampler launches, expected 3")
            emit({"request": i, "hw": [h, w], "t": t, "host_ms": round(host_ms, 3),
                  "launches": launched, "psnr_vs_shifted_mid": round(psnr(pred, mid), 3),
                  "psnr_frame0_vs_mid": round(psnr(f0, mid), 3)})
        main_path_launches = deformable_sample.launches
        emit({"main_path_launches": main_path_launches, "requests": len(requests)})

    with Phase("cpu"):
        torch.set_num_threads(os.cpu_count() or 1)
        f0, f1, _ = frames(tex, H, W, shift, 0.5)
        x0, x1 = (torch.from_numpy(f.astype(np.float32) / 255.0)[None] for f in (f0, f1))
        t5 = torch.full((1, 1, 1, 1), 0.5)
        with torch.inference_mode():
            gpu = model(x0.cuda(), x1.cuda(), t5.cuda()).cpu()
            cpu_model = load_model(DAT_fast, SHIPPED_STUDENT, device="cpu")
            cpu = cpu_model(x0, x1, t5)
        if not (torch.isfinite(gpu).all() and gpu.shape == (1, H, W, 3)):
            raise AssertionError(f"card output: shape {tuple(gpu.shape)} or non-finite")
        e2e_err = (gpu - cpu).abs().max().item()
        emit({"e2e_max_abs_err_vs_cpu": e2e_err, "mean_abs_err": (gpu - cpu).abs().mean().item(),
              "tol": E2E_TOL})
        if not e2e_err <= E2E_TOL:
            raise AssertionError(f"card vs CPU: {e2e_err} > {E2E_TOL}")

    per_level = {}
    with Phase("times"):
        xs = (x0.cuda(), x1.cuda(), t5.cuda())
        with torch.inference_mode():
            frame_ms = cuda_ms(lambda: model(*xs), iters=20, warmup=5)
        emit({"ms_per_frame_448x256_fp32": frame_ms, "card": card})
        for name, h, w, S, sc in LEVELS:
            feat, flow, res = level_inputs(gen, 2, h, w, 72, 1, S, sc)
            per_level[name] = level_times(feat, flow, res, deformable_sample,
                                          deformable_sample_plain)
            emit({"level": name, **per_level[name], "card": card})

    def total(key):
        return sum(v[key] for v in per_level.values())

    emit({"kernels": [{
        "name": "deformable_sample",
        "route": "cuda",
        "source": "videoframeinterpolation_tpu_torch/kernels/csrc/deformable_sample.cu",
        "replaces": "videoframeinterpolation_tpu/kernels/window_sample.py:158",
        "launches": main_path_launches,
        "max_abs_err": max_err,
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
        "library_ms": total("library_ms"),
        "per_level": per_level,
        "card": card,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def level_times(feat, flow, res, kernel, plain) -> dict:
    """One DAT level's sampler: kernel, plain version, bound and
    ``F.grid_sample`` on the same work (its inputs arranged beforehand)."""
    B2, h, w, C = feat.shape
    G, S = res.shape[3], res.shape[4]
    calls = kernel.launches
    ms = cuda_ms(lambda: kernel(feat, flow, res, G), iters=50)
    kernel.launches = calls   # timing launches are not main-path launches
    plain_ms = cuda_ms(lambda: plain(feat, flow, res, G), iters=10)

    # Library yardstick: NCHW input and a normalized (align_corners) grid.
    gy, gx = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float32),
                            torch.arange(w, device="cuda", dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([gx, gy], -1)[None, :, :, None, None] + (res + flow[:, :, :, None, None])
    coords = coords.permute(0, 3, 4, 1, 2, 5).reshape(B2 * G, S * h, w, 2)
    grid = torch.stack([coords[..., 0] * (2.0 / (w - 1)) - 1.0,
                        coords[..., 1] * (2.0 / (h - 1)) - 1.0], -1).contiguous()
    inp = feat.reshape(B2, h, w, G, C // G).permute(0, 3, 4, 1, 2).reshape(
        B2 * G, C // G, h, w).contiguous()
    library_ms = cuda_ms(lambda: F.grid_sample(inp, grid, mode="bilinear",
                                               padding_mode="zeros", align_corners=True),
                         iters=50)

    esize = feat.element_size()
    nbytes = esize * (B2 * S * h * w * C + feat.numel() + flow.numel() + res.numel())
    flops = 7 * B2 * S * h * w * C   # 4 multiplies and 3 adds per output element
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return {"shape": [B2, h, w, C, G, S], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bytes": nbytes,
            "share_of_bound": max(bytes_ms, ops_ms) / ms}


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
