"""The port and chip_smoke.py stay free of JAX and of packages the card's machine lacks.

The card's machine has the standard library, torch, numpy and a few test
packages, and none of jax, flax, orbax, yaml, msgpack or imageio; the port
must not come to need any of them, nor any module of the JAX package.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "videoframeinterpolation_tpu_torch"
FORBIDDEN = ("jax", "flax", "orbax", "yaml", "msgpack", "imageio", "videoframeinterpolation_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


# Records every module the import adds and every import statement executed
# by the port or chip_smoke, including names already imported elsewhere.
_PROBE = r"""
import builtins, json, sys
sys.path.insert(0, {root!r})
before = set(sys.modules)
requested = set()
_orig = builtins.__import__

def _import(name, globals=None, locals=None, fromlist=(), level=0):
    importer = (globals or {{}}).get("__name__", "")
    if level == 0 and (importer.startswith("videoframeinterpolation_tpu_torch")
                       or importer == "chip_smoke"):
        requested.add(name)
    return _orig(name, globals, locals, fromlist, level)

builtins.__import__ = _import
import importlib
for mod in {mods!r} + ["chip_smoke"]:
    importlib.import_module(mod)
print(json.dumps({{"added": sorted(set(sys.modules) - before),
                  "requested": sorted(requested)}}))
"""


def test_importing_the_port_and_chip_smoke_pulls_in_nothing_forbidden():
    code = _PROBE.format(root=str(ROOT), mods=_port_modules())
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    for mod in ("interpolate", "kernels.gather", "tools.perf.gather_probe",
                "tools.perf.lane_gather_probe", "tools.perf.sampler_probe", "tools.perf.timing",
                "config", "models.base", "data.synthetic", "eval.metrics", "tools.eval_best",
                "ops.losses", "train.schedule", "train.state", "train.step",
                "tools.head_to_head", "utils.yaml_subset", "utils.logger", "utils.flow_viz",
                "data.augment", "data.native", "data.vimeo90k", "parallel.ddp",
                "train.checkpoint", "train.preemption", "train.trainer", "train.__main__",
                "evaluate", "models.ifrnet", "models.dat_tpu", "nn.local_attn"):
        assert f"videoframeinterpolation_tpu_torch.{mod}" in result["added"]
    assert "chip_smoke" in result["added"]
    assert not [m for m in result["added"] if _forbidden(m)]
    assert not [m for m in result["requested"] if _forbidden(m)]


def test_no_source_of_the_port_or_chip_smoke_imports_anything_forbidden():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not bad


def test_chip_smoke_fails_without_a_cuda_device():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout
