"""The port's benchmark loops, its evaluation entry point and its evaluation tools against the JAX package (CPU).

One small DAT (``tests/torch_tiny.py``: nf 16, shared offsets, samples
4/4/2, perturbed parameters) written to a checkpoint by the port and read
by both sides; one jitted JAX forward per input shape for the whole file,
frames of 32x32 (30x30 for SNU-FILM's odd-sized triplet, padded to 32x32).

Tolerances, in fp32 on both sides:
  * each loop's result: the same keys, PSNR within 1e-4 dB and SSIM within
    1e-5 of the JAX loop's (the two frameworks sum the convolutions in
    different orders; the fixture frames are the same bytes, written by
    the port's PNG encoder and read by ``imageio`` on the JAX side);
  * the evaluation tools' records: the same keys and values, PSNR and
    SSIM within the same limits, against the JAX tools' protocol (and,
    marked ``slow``, against the JAX tools themselves, which initialise
    the model without jit and take about a minute each on the CPU);
  * the serving CLI's pair mode on PNG frames: within 1 level of 255 of
    the JAX CLI's ``_interp_pair`` on the same frames;
  * the loader and the Vimeo90K test split: equal batches and bytes.
"""

import dataclasses
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_tiny import TINY, TINY_FLAGS, TINY_STEP, jax_tiny, write_tiny_checkpoint
from videoframeinterpolation_tpu.data import DataLoader as JaxDataLoader
from videoframeinterpolation_tpu.data import Vimeo90K as JaxVimeo90K
from videoframeinterpolation_tpu.eval import benchmarks as jax_bench
from videoframeinterpolation_tpu.eval import metrics as jax_metrics
from videoframeinterpolation_tpu_torch import evaluate, interpolate
from videoframeinterpolation_tpu_torch.data import DataLoader, Vimeo90K, encode_png
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.eval import benchmarks
from videoframeinterpolation_tpu_torch.tools import eval_best, eval_instants, fixtures

ROOT = Path(__file__).resolve().parent.parent
PSNR_TOL = 1e-4
SSIM_TOL = 1e-5
HW = (32, 32)
# SNU-FILM: three triplets, so that each level lists its own (tools/fixtures.py).
TREES = {"vimeo90k": ([HW] * 3, 21), "ucf101": ([HW] * 2, 22),
         "snu": ([HW, (30, 30), HW], 23)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """``(checkpoint, port model, JAX infer)`` of the small DAT."""
    ckpt = write_tiny_checkpoint(tmp_path_factory.mktemp("ckpt") / "tiny.ckpt")
    model = interpolate.load_model(TINY, ckpt, device="cpu")
    _, params, apply = jax_tiny(ckpt)
    return ckpt, model, lambda a, b, t: apply(params, a, b, t)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    for bench, (hws, seed) in TREES.items():
        getattr(fixtures, f"write_{bench}")(base, hws, seed)
    return base


def _close(ours: dict, ref: dict) -> None:
    assert list(ours) == list(ref)
    for k, v in ref.items():
        tol = SSIM_TOL if k.endswith("_ssim") else PSNR_TOL
        assert abs(ours[k] - v) <= tol, (k, ours[k], v)


def _shape(text: str) -> list[str]:
    """Printed lines with their numbers masked."""
    return [re.sub(r"[-\d.]+", "#", line) for line in text.splitlines()]


def _jax_loop(bench: str, infer, **kw) -> dict:
    if bench == "vimeo90k":
        return jax_bench.validate_vimeo90k(infer, "datasets/vimeo_triplet", batch_size=2, **kw)
    if bench == "ucf101":
        return jax_bench.validate_ucf101(infer, root="datasets/UCF-101/test", **kw)
    return jax_bench.validate_snu(infer, root="datasets/SNU-FILM", **kw)


@pytest.mark.parametrize("bench", ["vimeo90k", "ucf101", "snu"])
def test_evaluate_cli_matches_the_jax_loop(tiny, trees, monkeypatch, capsys, bench):
    ckpt, model, jinfer = tiny
    loaded = []

    def load(cfg, path, device):
        loaded.append((cfg, path, device))
        return model

    monkeypatch.chdir(trees)
    monkeypatch.setattr(evaluate, "load_model", load)
    ours = evaluate.main(["--benchmark", bench, "--ssim", "--batch_size", "2", "--ckpt",
                          str(ckpt), "--device", "cpu"])
    our_lines = capsys.readouterr().out
    ref = _jax_loop(bench, jinfer, report_ssim=True)
    ref_lines = capsys.readouterr().out
    print(f"{bench}: port {ours}, JAX {ref}")
    _close(ours, ref)
    assert _shape(our_lines)[1:] == _shape(ref_lines)
    if bench == "snu":   # each level read its own list: no two levels agree
        psnrs = [v for k, v in ours.items() if k.endswith("_psnr")]
        assert len(psnrs) == 4 and len(set(psnrs)) == 4, ours
    # The preset's architecture, forced to fp32, as the JAX CLI evaluates.
    assert loaded[0][0].compute_dtype == "float32" and str(loaded[0][1]) == str(ckpt)


def test_validate_synthetic_matches_jax(tiny):
    _, model, jinfer = tiny
    kw = dict(seed=42, num_items=3, hw=HW, batch_size=2, report_ssim=True)
    ours = benchmarks.validate_synthetic(model, **kw)
    ref = jax_bench.validate_synthetic(jinfer, **kw)
    _close(ours, ref)


def test_evaluate_cli_routes_synthetic_and_refuses_what_is_not_ported(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(evaluate, "load_model", lambda cfg, path, device: torch.nn.Linear(1, 1))
    monkeypatch.setattr(evaluate, "validate_synthetic",
                        lambda infer, **kw: calls.append(kw) or {"val/synthetic_psnr": 1.0})
    evaluate.main(["--benchmark", "synthetic", "--batch_size", "3", "--device", "cpu"])
    assert calls == [{"seed": 42, "report_ssim": False, "batch_size": 3,
                      "device": torch.device("cpu")}]
    # --exp_name is ported: it reads the run's config.yaml and scores its
    # best checkpoint (or --ckpt, by name) under the config's log_dir.
    loaded = []
    monkeypatch.setattr(evaluate, "load_model",
                        lambda cfg, path, device: loaded.append((cfg, path)) or
                        torch.nn.Linear(1, 1))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "exps" / "x").mkdir(parents=True)
    Config(exp_name="x", seed=5, save_best_benchmark="ucf101").save_yaml(
        tmp_path / "exps" / "x" / "config.yaml")
    evaluate.main(["--exp_name", "x", "--benchmark", "synthetic", "--device", "cpu"])
    evaluate.main(["--exp_name", "x", "--ckpt", "latest", "--benchmark", "synthetic",
                   "--device", "cpu"])
    run = tmp_path / "exps" / "x" / "checkpoints"
    assert [(c.seed, c.compute_dtype, p) for c, p in loaded] == [
        (5, "float32", run / "best_ucf101.ckpt"), (5, "float32", run / "latest.ckpt")]
    # --window_sampling sets the config's flag, as the JAX CLI does.
    evaluate.main(["--exp_name", "x", "--window_sampling", "--benchmark", "synthetic",
                   "--device", "cpu"])
    assert [c.window_sampling for c, _ in loaded] == [False, False, True]


def test_cli_pair_mode_on_png_matches_the_jax_cli(tiny, tmp_path, monkeypatch):
    _, model, jinfer = tiny
    monkeypatch.setattr(interpolate, "load_model", lambda cfg, ckpt, device: model)
    img0, _, img1 = fixtures.triplet((30, 30), seed=24)
    paths = [tmp_path / "a.png", tmp_path / "b.png"]
    for p, img in zip(paths, (img0, img1)):
        p.write_bytes(encode_png(img))
    out = tmp_path / "mid.png"
    interpolate.main(["--frame0", str(paths[0]), "--frame1", str(paths[1]), "--out", str(out),
                      "--t", "0.25", "--device", "cpu"])
    spec = importlib.util.spec_from_file_location("jax_interpolate_cli", ROOT / "interpolate.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    ours = interpolate.read_frame(out)
    ref = cli._interp_pair(jinfer, img0, img1, 0.25)
    assert ours.shape == ref.shape == (30, 30, 3) and ours.dtype == ref.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref).max() <= 1


def test_snu_prefix_remap_and_the_list_layout(tmp_path):
    for p in ("data/SNU-FILM/test/x/0.png", "datasets/SNU-FILM/test/GOPRO_data_01/0001.png",
              "/abs/mydata/seq/0.png", "data"):
        assert benchmarks._fix_snu_prefix(p) == jax_bench._fix_snu_prefix(p)
    # The fixture's lists: one triplet in each of the first three levels, all in the last.
    root = fixtures.write_snu(tmp_path, [(16, 16)] * 3, 0)
    lists = [(root / level).read_text().splitlines() for level in benchmarks.SNU_LEVELS]
    assert [len(lines) for lines in lists] == [1, 1, 1, 3]
    assert lists[3] == lists[0] + lists[1] + lists[2]
    for line in lists[3]:
        paths = line.split()
        assert len(paths) == 3 and all(x.startswith("data/SNU-FILM/test/") for x in paths)
        assert all((tmp_path / benchmarks._fix_snu_prefix(x)).is_file() for x in paths)


class _Items:
    """Items that finish out of order: later indices sleep less."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(0.002 * ((7 * i) % 5))
        return {"i": np.array(i), "x": np.full((2,), i, np.float32)}


@pytest.mark.parametrize("kw", [dict(batch_size=3, shuffle=False, drop_last=False),
                                dict(batch_size=4, shuffle=False, drop_last=True),
                                dict(batch_size=2, shuffle=True, seed=5),
                                dict(batch_size=3, shuffle=True, num_shards=2, shard_index=1)])
def test_loader_yields_the_jax_loaders_batches(kw):
    ds = _Items(13)
    ours = [b["i"].tolist() for b in DataLoader(ds, num_workers=4, **kw)]
    # One JAX worker, so that its batches come in order whatever the timing.
    ref = [b["i"].tolist() for b in JaxDataLoader(ds, num_workers=1, **kw)]
    assert ours == ref and len(ours) == len(DataLoader(ds, **kw))
    assert all(b["x"].shape == (len(b["i"]), 2) for b in DataLoader(ds, num_workers=3, **kw))


def test_loader_keeps_the_order_under_thread_switches():
    """More workers than cores, a thread switch every microsecond, items
    that finish in random order: the batches still come in index order."""
    import threading

    class Jittery(_Items):
        def __getitem__(self, i):
            time.sleep(np.random.default_rng(i).random() * 0.003)
            return {"i": np.array(i)}

    got, interval = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = DataLoader(Jittery(97), batch_size=5, shuffle=False, drop_last=False,
                            num_workers=32, prefetch=2)
        runner = threading.Thread(target=lambda: got.extend(b["i"].tolist() for b in loader))
        runner.start()
        runner.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not runner.is_alive()
    assert got == [list(range(i, min(i + 5, 97))) for i in range(0, 97, 5)]


def test_loader_reraises_an_item_error():
    class Bad(_Items):
        def __getitem__(self, i):
            if i == 4:
                raise OSError("unreadable frame")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="unreadable"):
        list(DataLoader(Bad(8), batch_size=2, shuffle=False))


def test_vimeo90k_test_split_gives_the_jax_bytes(trees):
    root = str(trees / "datasets" / "vimeo_triplet")
    ours, ref = Vimeo90K(root, is_train=False), JaxVimeo90K(root, is_train=False)
    assert len(ours) == len(ref) == 3
    for i in range(3):
        a, b = ours[i], ref[i]
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)
    # The training split is ported (tests/test_torch_vimeo_train.py holds it
    # in full): over a training list of the same sequences, with the same
    # seed, the two frameworks' augmented items are equal.
    (trees / "datasets" / "vimeo_triplet" / "tri_trainlist.txt").write_text(
        (trees / "datasets" / "vimeo_triplet" / "tri_testlist.txt").read_text())
    ours, ref = Vimeo90K(root, (16, 16), seed=9), JaxVimeo90K(root, (16, 16), seed=9)
    assert ours.is_train and len(ours) == len(ref) == 3
    for i in range(3):
        a, b = ours[i], ref[i]
        assert all(np.array_equal(a[k], b[k]) for k in b) and list(a) == list(b)


def _jax_tool_records(ckpt, jinfer, ts) -> list[dict]:
    """The JAX tools' protocol (``tools/quality/eval_best.py``,
    ``eval_instants.py``): pools of 2 scenes at 32x32, seed 42, per-item
    unclipped PSNR and SSIM with ``val_range=1.0``, means, rounded as the
    tools write them."""
    sys.path.insert(0, str(ROOT / "tools" / "quality"))
    from head_to_head import build_pool

    records = []
    for t in ts:
        pool = build_pool(2, HW, 42, is_train=False, **({} if t is None else {"fixed_t": t}))
        pred = jinfer(*(jnp.asarray(pool[k]) for k in ("x0", "x1", "t")))
        gt = jnp.asarray(pool["xt"])
        ps = [float(jax_metrics.psnr(pred[j], gt[j])) for j in range(2)]
        ss = [float(jax_metrics.ssim_3d(pred[j:j + 1], gt[j:j + 1], val_range=1.0))
              for j in range(2)]
        rec = {"ckpt": str(ckpt), "step": TINY_STEP}
        if t is not None:
            rec["t"] = round(t, 4)
        records.append({**rec, "psnr": round(float(np.mean(ps)), 4),
                        "ssim": round(float(np.mean(ss)), 5), "n": 2, "crop": 32, "seed": 42})
    return records


def _tool_lines(tool, argv, capsys) -> list[dict]:
    tool.main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def _records_close(ours: list[dict], ref: list[dict]) -> None:
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if k not in ("psnr", "ssim")} == \
            {k: v for k, v in b.items() if k not in ("psnr", "ssim")}
        # Rounded to 4 and 5 places on both sides: one unit of the last place.
        assert abs(a["psnr"] - b["psnr"]) <= PSNR_TOL + 1e-4
        assert abs(a["ssim"] - b["ssim"]) <= SSIM_TOL + 1e-5


@pytest.mark.parametrize("tool", ["eval_best", "eval_instants"])
def test_eval_tools_match_the_jax_protocol(tiny, tmp_path, capsys, monkeypatch, tool):
    ckpt, _, jinfer = tiny
    results = sorted((ROOT / "tools" / "quality" / "results").glob("*.jsonl"))
    before = {p: p.read_bytes() for p in results}
    monkeypatch.chdir(tmp_path)
    argv = ["--ckpt", str(ckpt), *TINY_FLAGS, "--eval_items", "2", "--crop", "32",
            "--device", "cpu"]
    if tool == "eval_best":
        ours, ts = _tool_lines(eval_best, argv, capsys), [None]
    else:
        ours = _tool_lines(eval_instants, argv + ["--instants", "1/4,2/4"], capsys)
        ts = [0.25, 0.5]
    _records_close(ours, _jax_tool_records(ckpt, jinfer, ts))
    # Nothing written without --out: not in the working directory, not to
    # the committed records.
    assert not list(tmp_path.iterdir())
    assert results and {p: p.read_bytes() for p in results} == before


def test_eval_tools_take_the_preset_or_the_jax_architecture_flags():
    ap = eval_best.argparse.ArgumentParser()
    eval_best.add_arguments(ap)
    cfg, ckpts = eval_best.config_and_ckpts(ap.parse_args(["--config", "DAT"]))
    assert cfg == eval_best.PRESETS["DAT"].config and ckpts == [eval_best.PRESETS["DAT"].ckpt]
    cfg, ckpts = eval_best.config_and_ckpts(ap.parse_args(["--ckpt", "c", *TINY_FLAGS]))
    assert cfg == dataclasses.replace(TINY, compute_dtype="bfloat16")
    assert ckpts == ["c"]
    cfg, _ = eval_best.config_and_ckpts(ap.parse_args(["--ckpt", "c", "--samples", "8,8,4",
                                                       "--shared"]))
    assert (cfg.nf, cfg.shared_offsets, tuple(cfg.dat_samples), cfg.dec_res_blocks) == \
        (72, True, (8, 8, 4), 10)
    with pytest.raises(SystemExit, match="--ckpt"):
        eval_best.config_and_ckpts(ap.parse_args(["--nf", "16"]))
    assert eval_instants.parse_instants("1/8,0.5,7/8") == [0.125, 0.5, 0.875]


@pytest.mark.slow
@pytest.mark.parametrize("tool", ["eval_best", "eval_instants"])
def test_eval_tools_match_the_jax_tools(tiny, tmp_path, capsys, monkeypatch, tool):
    """The JAX tool itself on the same checkpoint (about a minute on the
    CPU: it initialises the model without jit)."""
    import runpy

    ckpt, _, _ = tiny
    argv = ["--ckpt", str(ckpt), *TINY_FLAGS, "--eval_items", "2", "--crop", "32"]
    extra = ["--instants", "1/4,2/4"] if tool == "eval_instants" else []
    ours = _tool_lines(globals()[tool], argv + extra + ["--device", "cpu"], capsys)
    out = tmp_path / "jax.jsonl"
    root = ROOT
    monkeypatch.setattr(sys, "argv", [tool, *argv, *extra, "--out", str(out)])
    monkeypatch.syspath_prepend(str(root / "tools" / "quality"))
    runpy.run_path(str(root / "tools" / "quality" / f"{tool}.py"), run_name="__main__")
    capsys.readouterr()
    _records_close(ours, [json.loads(line) for line in out.read_text().splitlines()])
