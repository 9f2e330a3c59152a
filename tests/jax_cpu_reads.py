"""The JAX package's CPU fp32 reads that ``chip_smoke.py`` holds the card to (a script, not a test).

    JAX_PLATFORMS=cpu python tests/jax_cpu_reads.py \
        [--part synthetic|trees|plan|families|variants|all]

Prints one JSON line per read, for the constants of ``chip_smoke.py``:

  * ``synthetic``: ``eval/benchmarks.py:validate_synthetic`` of each
    committed preset's checkpoint in fp32 (256x448, batches of 4, seed 42,
    with SSIM) over ``chip_smoke.SYNTHETIC_ITEMS`` scenes
    (``JAX_SYNTHETIC``);
  * ``trees``: the Vimeo90K, UCF101 and SNU-FILM loops of the shipped
    student in fp32 on the fixture trees of ``chip_smoke.FIXTURE_TREES``,
    written by the port's ``tools/fixtures.py`` (``JAX_TREES``);
  * ``plan``: the flow-aware tiling plan ``(overlap, trim)`` and the probe's
    magnitude for ``chip_smoke.HD_PAIR`` at ``--tile 512``, as the JAX
    ``evaluate.py`` (fp32) and ``interpolate.py`` (the YAML's bf16) make it
    (``JAX_HD_PLAN``);
  * ``families``: the fp32 frame of IFRNet, DAT-TPU, the dilated +
    group-offset DAT-TPU, DCNDAT and DCNTrans v1 (``chip_smoke.FAMILIES``,
    at full width from their YAMLs) at t = 0.5 on the held-out scene
    ``chip_smoke.FAMILY_SCENE``, with the parameters
    ``chip_smoke.seeded_family_state`` draws, written by the port's
    checkpoint writer and read by flax: its PSNR against the scene's true
    middle frame and its mean (``JAX_FAMILIES``);
  * ``variants``: the same read (``JAX_VARIANTS``) of the quality study's
    two arms of the flagship (``chip_smoke.VARIANTS`` on
    ``configs/DAT_fast.yaml``, the parameters ``chip_smoke.seeded_state``
    draws from ``chip_smoke.VARIANT_SEED``), and of the committed ``DAT``
    checkpoint with ``dat_ref_offset_units``.

The 256x448 reads take about a minute per batch of 4 on an 8-core host,
most of it in ``ssim_3d``; the non-shared ``DAT`` needs about 18 GiB.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization as fser  # noqa: E402

import chip_smoke  # noqa: E402
from videoframeinterpolation_tpu.config import Config  # noqa: E402
from videoframeinterpolation_tpu.eval import benchmarks  # noqa: E402
from videoframeinterpolation_tpu.models import create_model  # noqa: E402
from videoframeinterpolation_tpu.parallel.spatial import _plan_tiles, make_flow_probe  # noqa: E402
from videoframeinterpolation_tpu_torch.config import PRESETS  # noqa: E402
from videoframeinterpolation_tpu_torch.tools import fixtures  # noqa: E402

YAMLS = {"DAT_fast": ("configs/DAT_fast.yaml", {}), "DAT": ("configs/DAT.yaml", {}),
         "DAT_fast_teacher": ("configs/DAT_fast.yaml", {"dat_samples": [8, 16, 8]})}


def model_and_params(name: str, dtype: str = "float32"):
    path, overrides = YAMLS[name]
    model = create_model(Config.from_yaml(ROOT / path, compute_dtype=dtype, **overrides))
    return model, fser.msgpack_restore(PRESETS[name].ckpt.read_bytes())["params"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def synthetic() -> None:
    for name in YAMLS:
        model, params = model_and_params(name)
        infer_jit = jax.jit(model.apply)
        start = time.perf_counter()
        res = benchmarks.validate_synthetic(lambda a, b, t: infer_jit(params, a, b, t), seed=42,
                                            num_items=chip_smoke.SYNTHETIC_ITEMS,
                                            batch_size=4, report_ssim=True)
        emit({"synthetic": name, "num_items": chip_smoke.SYNTHETIC_ITEMS, **res,
              "seconds": time.perf_counter() - start})


def trees() -> None:
    model, params = model_and_params("DAT_fast")
    infer_jit = jax.jit(model.apply)

    def infer(a, b, t):
        return infer_jit(params, a, b, t)

    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for bench, (hws, seed) in chip_smoke.FIXTURE_TREES.items():
                getattr(fixtures, f"write_{bench}")(tmp, hws, seed)
                if bench == "vimeo90k":
                    res = benchmarks.validate_vimeo90k(infer, "datasets/vimeo_triplet",
                                                       batch_size=4)
                elif bench == "ucf101":
                    res = benchmarks.validate_ucf101(infer, root="datasets/UCF-101/test")
                else:
                    res = benchmarks.validate_snu(infer, root="datasets/SNU-FILM")
                emit({"tree": bench, **res})
        finally:
            os.chdir(cwd)


def plan() -> None:
    hw, seed = chip_smoke.HD_PAIR
    x0, _, x1 = (jnp.asarray(f.astype("float32")[None] / 255.0)
                 for f in fixtures.triplet(hw, seed))
    t = jnp.full((1, 1, 1, 1), 0.5, jnp.float32)
    for cli, dtype in (("evaluate", "float32"), ("interpolate", "bfloat16")):
        model, params = model_and_params("DAT_fast", dtype)
        probe = make_flow_probe(lambda p, a, b, tt, train: model.apply(p, a, b, tt, train=train))
        mag = probe(params, x0, x1, t)
        got = _plan_tiles(lambda *a: mag, params, x0, x1, t, chip_smoke.HD_TILE,
                          default_flow_px=32.0, unsafe_plan="full")
        emit({"plan": cli, "dtype": dtype, "hw": list(hw), "tile": chip_smoke.HD_TILE,
              "flow_mag_px": mag, "overlap_trim": list(got) if got else None})


def families() -> None:
    from videoframeinterpolation_tpu_torch.train import state_to_flax, write_flax_state

    x0, mid, x1 = fixtures.triplet(*chip_smoke.FAMILY_SCENE)
    x0, x1 = (jnp.asarray(f.astype("float32")[None] / 255.0) for f in (x0, x1))
    t = jnp.full((1, 1, 1, 1), 0.5, jnp.float32)
    for name, yaml in chip_smoke.FAMILIES.items():
        cfg, state = chip_smoke.seeded_family_state(name)
        overrides = ({"offset_sets": cfg.offset_sets, "n_offset_groups": cfg.n_offset_groups}
                     if name.endswith("_dilated_goff") else {})
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "family.ckpt"
            write_flax_state(path, state_to_flax(state))
            params = fser.msgpack_restore(path.read_bytes())["params"]
        model = create_model(Config.from_yaml(ROOT / yaml, compute_dtype="float32", **overrides))
        start = time.perf_counter()
        frame = np.asarray(jax.jit(model.apply)(params, x0, x1, t))[0]
        emit({"family": name, "psnr": chip_smoke.frame_psnr(frame, mid),
              "mean": float(frame.mean(dtype=np.float64)),
              "seconds": time.perf_counter() - start})


def variants() -> None:
    from videoframeinterpolation_tpu_torch.train import state_to_flax, write_flax_state

    x0, mid, x1 = fixtures.triplet(*chip_smoke.FAMILY_SCENE)
    x0, x1 = (jnp.asarray(f.astype("float32")[None] / 255.0) for f in (x0, x1))
    t = jnp.full((1, 1, 1, 1), 0.5, jnp.float32)
    reads = {}
    for name, fields in chip_smoke.VARIANTS.items():
        state = chip_smoke.seeded_state(chip_smoke.variant_config(name), chip_smoke.VARIANT_SEED)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "variant.ckpt"
            write_flax_state(path, state_to_flax(state))
            params = fser.msgpack_restore(path.read_bytes())["params"]
        reads[name] = (create_model(Config.from_yaml(ROOT / "configs" / "DAT_fast.yaml",
                                                     compute_dtype="float32", **fields)), params)
    dat = create_model(Config.from_yaml(ROOT / YAMLS["DAT"][0], compute_dtype="float32",
                                        dat_ref_offset_units=True))
    reads["DAT_ref_offset_units"] = (dat, model_and_params("DAT")[1])
    for name, (model, params) in reads.items():
        start = time.perf_counter()
        frame = np.asarray(jax.jit(model.apply)(params, x0, x1, t))[0]
        emit({"variant": name, "psnr": chip_smoke.frame_psnr(frame, mid),
              "mean": float(frame.mean(dtype=np.float64)),
              "seconds": time.perf_counter() - start})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=["synthetic", "trees", "plan", "families", "variants",
                                       "all"], default="all")
    part = ap.parse_args().part
    jax.config.update("jax_platforms", "cpu")
    for name, fn in (("plan", plan), ("trees", trees), ("families", families),
                     ("variants", variants), ("synthetic", synthetic)):
        if part in (name, "all"):
            fn()


if __name__ == "__main__":
    main()
