"""The port's production trainer against the JAX training loop (CPU, tiny widths).

A small flagship (``tests/test_torch_train.py``'s: nf 16, one encoder and
one decoder block, shared offsets, samples 8/8/2) trains in fp32 for 2
epochs of 2 steps (batch 2, crops of 32x32, ``num_workers=1``) on a seeded
Vimeo90K-layout tree with flows. The JAX reference is built from the JAX
package's own pieces: its ``Vimeo90KwFlow`` and ``DataLoader`` with the
trainer's per-epoch seeding and ``make_train_step`` on ``create_mesh(1)``,
started from the port's initial parameters. Tolerances, those of
``tests/test_torch_train.py``:

  * every logged loss within ``LOSS_TOL`` (1e-5) relative, every step;
  * the final AdamW first moment (a mean of the gradients) of each
    parameter within ``GRAD_TOL`` (1e-4) of its max abs, floored at
    ``FLOOR`` (1%) of the largest parameter's; the second moment the same
    on its square root (an RMS of the gradients);
  * the parameters' change over the run the same, where the first moment
    is above the floor (below it, a gradient that is zero in exact
    arithmetic leaves a direction set by rounding, which Adam normalises).

The logged ``lr`` equals JAX's, the checkpoint names and ``meta.json``
follow JAX's cadence, and ``metrics.jsonl`` has the JAX logger's keys.
"""

import json
import os
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization as fser

from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.data import DataLoader as JaxLoader
from videoframeinterpolation_tpu.data.vimeo90k import Vimeo90KwFlow as JaxVimeo90KwFlow
from videoframeinterpolation_tpu.models import create_model as jax_create_model
from videoframeinterpolation_tpu.parallel import create_mesh, shard_batch
from videoframeinterpolation_tpu.parallel.mesh import replicated_sharding
from videoframeinterpolation_tpu.train.checkpoint import (
    restore_teacher_params as jax_restore_teacher)
from videoframeinterpolation_tpu.train.schedule import warmup_cosine_lr as jax_lr
from videoframeinterpolation_tpu.train.state import create_optimizer as jax_optimizer
from videoframeinterpolation_tpu.train.state import create_train_state as jax_train_state
from videoframeinterpolation_tpu.train.step import make_train_step
from videoframeinterpolation_tpu.utils.flow_viz import flow_to_image as jax_flow_to_image
from videoframeinterpolation_tpu.utils import logger as jax_logger
from videoframeinterpolation_tpu.utils.logger import Logger as JaxLogger
from videoframeinterpolation_tpu_torch import evaluate
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.models import create_model
from videoframeinterpolation_tpu_torch.tools import fixtures
from videoframeinterpolation_tpu_torch.train import (PreemptionGuard, create_train_state,
                                                     state_from_flax, state_to_flax)
from videoframeinterpolation_tpu_torch.train import checkpoint as ckpt_mod
from videoframeinterpolation_tpu_torch.train import trainer as trainer_mod
from videoframeinterpolation_tpu_torch.train.trainer import Trainer
from videoframeinterpolation_tpu_torch.utils import logger as port_logger
from videoframeinterpolation_tpu_torch.utils.flow_viz import flow_to_image

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 1e-6
FLOOR = 1e-2
TINY = dict(nf=16, enc_res_blocks=1, dec_res_blocks=1, shared_offsets=True,
            dat_samples=(8, 8, 2))
RUN = dict(TINY, compute_dtype="float32", crop_h=32, crop_w=32, batch_size=2, num_workers=1,
           num_epochs=2, warmup_steps=2, metric_summary_freq=1, img_summary_freq=2,
           save_latest_freq=3, save_every_freq_epoch=1, valid_freq_epoch=1)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    # Both loggers write TensorBoard files where torch.utils.tensorboard
    # imports; here that import pulls in TensorFlow (about 12 s) and the
    # tests read the JSONL and PNG files only.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_logger, "_try_tensorboard", lambda log_dir: None)
        mp.setattr(jax_logger, "_try_tensorboard", lambda log_dir: None)
        yield


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A tree of 4 training triplets (40x48, flows) and 2 test triplets."""
    base = tmp_path_factory.mktemp("trainer")
    fixtures.write_vimeo90k_train(base, 4, (40, 48), [(32, 32)] * 2, seed=8)
    return base


def _in(base: Path, fn, *args, **kw):
    cwd = os.getcwd()
    os.chdir(base)
    try:
        return fn(*args, **kw)
    finally:
        os.chdir(cwd)


def _train(base: Path, name: str, guard=None, resume=None, **overrides) -> Trainer:
    """The port's trainer on the tree, in ``base`` (the config's relative
    roots), logging under ``exps/<name>``."""
    cfg = Config(exp_name=name, **{**RUN, **overrides})

    def run():
        trainer = Trainer(cfg, device="cpu")
        if resume:
            assert trainer.resume(resume)
        trainer.train(preemption_guard=guard)
        trainer.close()
        return trainer

    return _in(base, run)


@pytest.fixture(scope="module")
def port_run(base, no_tensorboard):
    torch.set_num_threads(1)
    torch.manual_seed(RUN.get("seed", 42))
    init = state_to_flax(create_train_state(create_model(Config(**RUN), torch.float32),
                                            Config(**RUN)))
    trainer = _train(base, "run")
    return init, trainer


@pytest.fixture(scope="module")
def jax_run(base, port_run):
    """The JAX loop of ``train/trainer.py:157-236`` from the JAX package's
    pieces, from the port's initial parameters; its per-step logs."""
    init, _ = port_run
    cfg = JaxConfig(**RUN)
    root = str(base / cfg.root)
    dataset = JaxVimeo90KwFlow(root, cfg.flow_dir, cfg.distill_bwd, (cfg.crop_h, cfg.crop_w),
                               is_train=True, seed=cfg.seed)
    assert dataset.use_native   # as the port's default
    loader = JaxLoader(dataset, cfg.batch_size, shuffle=True, drop_last=True,
                       num_workers=cfg.num_workers, seed=cfg.seed)
    mesh = create_mesh(1)
    model = jax_create_model(cfg)
    # Placed and typed as the step returns it, so that it compiles once.
    state = jax_train_state(model, init["params"], cfg)
    state = jax.device_put(state.replace(step=np.int32(0)), replicated_sharding(mesh))
    train_step = make_train_step(model, cfg, mesh)
    logs, step = [], 0
    for epoch in range(cfg.num_epochs):
        loader.set_epoch(epoch)
        dataset.seed(cfg.seed * 100003 + epoch)
        for batch in loader:
            state, log = train_step(state, shard_batch(batch, mesh))
            step += 1
            metrics = {k: float(v) for k, v in log.items()}
            metrics["lr"] = float(jax_lr(step - 1, cfg.start_lr, cfg.end_lr,
                                         cfg.last_lr_decay_iter, cfg.warmup_steps))
            logs.append(metrics)
    assert train_step._cache_size() == 1
    return jax.tree_util.tree_map(np.asarray, fser.to_state_dict(state)), logs


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _records(base: Path, name: str) -> list[dict]:
    return [json.loads(line) for line in
            (base / "exps" / name / "metrics.jsonl").read_text().splitlines()]


def test_two_epochs_match_the_jax_loop(base, port_run, jax_run):
    init, trainer = port_run
    ref_tree, ref_logs = jax_run
    records = _records(base, "run")
    train = [r for r in records if any(k.startswith("train/") for k in r)]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    for rec, ref in zip(train, ref_logs):
        for k, v in ref.items():
            if k == "lr":
                assert rec["train/lr"] == v
            else:
                assert abs(rec[f"train/{k}"] - v) <= LOSS_TOL * abs(v), (rec["step"], k)

    ours = _leaves(state_to_flax(trainer.state))
    ref = _leaves(ref_tree)
    start = _leaves(init)
    assert int(ours["step"]) == int(ref["step"]) == 4
    mu = {k[len("opt_state/0/mu/"):]: v for k, v in ref.items() if k.startswith("opt_state/0/mu/")}
    largest = max(np.abs(v).max() for v in mu.values())
    worst = {}
    for k, v in mu.items():
        floor = FLOOR * largest
        pairs = [("mu", ours[f"opt_state/0/mu/{k}"], v),
                 ("rms", np.sqrt(ours[f"opt_state/0/nu/{k}"]), np.sqrt(ref[f"opt_state/0/nu/{k}"]))]
        above = np.abs(v) > floor
        moved_ref = ref[f"params/{k}"] - start[f"params/{k}"]
        moved = ours[f"params/{k}"] - start[f"params/{k}"]
        pairs.append(("params", moved[above], moved_ref[above]))
        for what, got, want in pairs:
            if want.size == 0:
                continue
            scale = max(np.abs(want).max(), floor if what != "params" else 0.0)
            err = np.abs(got - want).max() / scale if scale else np.abs(got).max()
            worst[what] = max(worst.get(what, 0.0), err)
            assert err <= GRAD_TOL, (what, k, err)
    print(f"worst error over max abs: {worst}")


def test_checkpoints_and_logs_follow_the_jax_cadence(base, port_run):
    _, trainer = port_run
    run = base / "exps" / "run"
    records = _records(base, "run")
    val = [r for r in records if "val/vimeo90k/val/vimeo90k_psnr" in r]
    assert [r["step"] for r in val] == [1, 2]
    psnr = [r["val/vimeo90k/val/vimeo90k_psnr"] for r in val]
    # JAX's logger, fed the same values, writes the same keys.
    jlog = JaxLogger(str(base / "jax_logger"), metric_summary_freq=1)
    jlog.push({k[len("train/"):]: v for k, v in records[0].items() if k.startswith("train/")})
    jlog.write_dict({"val/vimeo90k_psnr": psnr[0]}, step=1)
    jlog.close()
    jrec = [json.loads(line) for line in
            (base / "jax_logger" / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in jrec] == [sorted(records[0]), sorted(val[0])]
    # latest at step 3 (save_latest_freq), epoch_XXX every epoch, best_vimeo90k
    # at each improvement, with JAX's metadata.
    best = max(psnr)
    meta = {p.name[:-len(".meta.json")]: json.loads(p.read_text())
            for p in (run / "checkpoints").glob("*.meta.json")}
    assert meta["latest"] == {"step": 3, "epoch": 1, "best_psnr": psnr[0]}
    assert meta["epoch_001"] == {"step": 2, "epoch": 1, "best_psnr": 0.0}
    assert meta["epoch_002"] == {"step": 4, "epoch": 2, "best_psnr": psnr[0]}
    assert meta["best_vimeo90k"] == {"step": 2 if best == psnr[0] else 4,
                                     "epoch": 1 if best == psnr[0] else 2, "best_psnr": best}
    assert sorted(p.name for p in (run / "checkpoints").glob("*.ckpt")) == [
        "best_vimeo90k.ckpt", "epoch_001.ckpt", "epoch_002.ckpt", "latest.ckpt"]
    assert sorted(p.name for p in (run / "images").iterdir()) == [
        "flow_0000002.png", "flow_0000004.png", "pred_0000002.png", "pred_0000004.png"]
    assert Config.from_yaml(run / "config.yaml").to_dict() == JaxConfig.from_yaml(
        run / "config.yaml").to_dict()
    # Every checkpoint restores bit for bit into a fresh state.
    cfg = Config(**RUN)
    for name in ("latest", "epoch_002"):
        tree, m = trainer.ckpt.restore(name)
        state = create_train_state(create_model(cfg, torch.float32), cfg)
        state_from_flax(tree, state)
        assert state.step == m["step"]
        again = _leaves(state_to_flax(state))
        assert all(np.array_equal(again[k], v) for k, v in _leaves(tree).items())


def test_preemption_then_resume_equals_the_uninterrupted_run(base, port_run):
    _, full = port_run
    guard = PreemptionGuard()
    guard.trip()
    cut = _train(base, "preempted", guard=guard)
    assert cut.state.step == 1 and cut.ckpt.exists("latest")
    resumed = _train(base, "preempted", resume="latest")
    a, b = _leaves(state_to_flax(full.state)), _leaves(state_to_flax(resumed.state))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    steps = [r["step"] for r in _records(base, "preempted") if "train/total_loss" in r]
    assert steps == [1, 2, 3, 4]


def test_grad_clip_three_steps_and_its_opt_state_crosses_both_ways(tmp_path):
    """Three steps of the port's optimizer with ``grad_clip`` against
    ``optax.chain(clip_by_global_norm, adamw)`` as the JAX package builds it
    (the clip firing, not firing, firing), within ``ADAM_TOL`` of
    ``tests/test_torch_losses.py``; then a model's clipped TrainState
    crosses to JAX's chained TrainState and back, bit for bit."""
    over = dict(grad_clip=0.05, warmup_steps=0)
    cfg, jcfg = Config(**{**RUN, **over}), JaxConfig(**{**RUN, **over})
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    tx = jax_optimizer(jcfg)
    jstate, jparams = tx.init(params), params
    ours = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = create_train_state(create_model(cfg, torch.float32), cfg).tx
    ostate = opt.init(ours)
    for scale in (1.0, 0.01, 1.0):
        grads = {k: (rng.standard_normal(s) * 0.05 * scale).astype(np.float32)
                 for k, s in shapes.items()}
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update(ours, {k: torch.from_numpy(v) for k, v in grads.items()}, ostate)
    adam = jstate[1][0]
    for k in shapes:
        for got, want in ((ours[k], jparams[k]), (ostate.exp_avg[k], adam.mu[k]),
                          (ostate.exp_avg_sq[k], adam.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ADAM_TOL, atol=0)

    torch.manual_seed(0)
    state = create_train_state(create_model(cfg, torch.float32), cfg)
    gen = torch.Generator().manual_seed(1)
    for moments in (state.opt_state.exp_avg, state.opt_state.exp_avg_sq):
        for t in moments.values():
            t.copy_(torch.rand(t.shape, generator=gen))
    state.step = state.opt_state.count = state.opt_state.schedule_count = 3
    path = tmp_path / "clip.ckpt"
    ckpt_mod.write_flax_state(path, state_to_flax(state))
    model = jax_create_model(jcfg)
    template = jax.eval_shape(lambda p: jax_train_state(model, p, jcfg),
                              state_to_flax(state)["params"])
    restored = fser.to_state_dict(fser.from_bytes(template, path.read_bytes()))
    assert set(restored["opt_state"]) == {"0", "1"} and restored["opt_state"]["0"] == {}
    back = create_train_state(create_model(cfg, torch.float32), cfg)
    state_from_flax(jax.tree_util.tree_map(np.asarray, restored), back)
    a, b = _leaves(state_to_flax(state)), _leaves(state_to_flax(back))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_port_checkpoint_restores_as_a_teacher_in_both(base, port_run, tmp_path):
    _, trainer = port_run
    run = base / "exps" / "run" / "checkpoints"
    cfg = JaxConfig(**RUN)
    template = state_to_flax(trainer.state)["params"]
    restored = jax_restore_teacher(str(run / "best_vimeo90k.ckpt"), jax_create_model(cfg),
                                   template, cfg)
    ours = ckpt_mod.restore_teacher_params(run / "best_vimeo90k")   # without the suffix
    a, b = _leaves(jax.tree_util.tree_map(np.asarray, restored)), _leaves(ours)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        ckpt_mod.restore_teacher_params(tmp_path / "orbax_dir")
    with pytest.raises(FileNotFoundError):
        ckpt_mod.restore_teacher_params(tmp_path / "missing")
    # The trainer distils from it (teacher_overrides build the teacher).
    student = _train(base, "student", num_epochs=1, val_datasets=(),
                     teacher_ckpt=str(run / "best_vimeo90k"),
                     teacher_overrides={"dat_samples": [8, 8, 2]}, distill_teacher_w=1.0)
    assert student.teacher is not None and student.state.step == 2
    assert all("train/teacher_loss" in r for r in _records(base, "student"))


def test_flow_to_image_equals_jax():
    rng = np.random.default_rng(0)
    for flow in ((rng.standard_normal((9, 13, 2)) * 4).astype(np.float32),
                 np.zeros((4, 5, 2), np.float32)):
        assert np.array_equal(flow_to_image(flow), jax_flow_to_image(flow))
        assert np.array_equal(flow_to_image(flow, 1.0), jax_flow_to_image(flow, 1.0))


def test_evaluate_exp_name_reads_the_run(base, port_run, capsys):
    run = Path("exps") / "run"
    by_name = _in(base, evaluate.main, ["--exp_name", "run", "--device", "cpu"])
    by_file = _in(base, evaluate.main, ["--config", str(run / "config.yaml"), "--ckpt",
                                        str(run / "checkpoints" / "best_vimeo90k.ckpt"),
                                        "--device", "cpu"])
    assert by_name == by_file
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "PSNR" in ln]
    assert len(lines) == 2 and lines[0] == lines[1]


@pytest.mark.slow
def test_jax_trainer_against_the_port(base, port_run, tmp_path):
    """The JAX package's whole ``Trainer`` (its loop, cadences and
    validation) from the port's initial parameters, against the port's run."""
    from videoframeinterpolation_tpu.train.trainer import Trainer as JaxTrainer

    init, trainer = port_run
    cfg = JaxConfig(exp_name="jax", log_dir=str(tmp_path / "jax"), **RUN)
    jt = _in(base, JaxTrainer, cfg)
    jt.mesh = create_mesh(1)
    jt.n_devices = 1
    jt.train_step = make_train_step(jt.model, cfg, jt.mesh)
    jt.state = jax.device_put(jt.state.replace(params=init["params"]),
                              replicated_sharding(jt.mesh))
    _in(base, jt.train)
    ref = [json.loads(line) for line in (tmp_path / "jax" / "metrics.jsonl").read_text().splitlines()]
    ours = _records(base, "run")
    assert [sorted(r) for r in ref] == [sorted(r) for r in ours]
    for a, b in zip(ours, ref):
        for k, v in b.items():
            if k.endswith("_loss") or k.endswith("_psnr"):
                assert abs(a[k] - v) <= 1e-4 * abs(v), k


class _Event:
    """A stand-in for one of the profiler's raw events."""

    def __init__(self, name, start_ms, end_ms, device="CUDA", annotation=False):
        self._name, self._start, self._end = name, int(start_ms * 1e6), int(end_ms * 1e6)
        self._device, self._annotation = getattr(torch.autograd.DeviceType, device), annotation

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def duration_ns(self):
        return self._end - self._start


def test_profile_summary_reads_the_raw_device_events():
    """The trace's summary from the profiler's raw events: busy time is the
    union of the device operations' intervals (two streams overlapping
    count once), host operations and the device's range annotations are
    no operations, and the top operations are summed by name; a trace of
    the CPU alone has no busy share."""
    from types import SimpleNamespace

    events = [_Event("gemm", 0, 4), _Event("gemm", 10, 12), _Event("copy", 3, 6),
              _Event("aten::mm", 0, 20, device="CPU"),
              _Event("swin_decoder", 0, 12, annotation=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    summary = trainer_mod.profile_summary(prof, wall_ms=20.0, steps=2)
    assert summary["device_busy_ms_per_step"] == pytest.approx(4.0)
    assert summary["busy_share"] == pytest.approx(0.4)
    assert [(r["op"], r["calls_per_step"]) for r in summary["top"]] == [("gemm", 1.0),
                                                                         ("copy", 0.5)]
    assert summary["top"][0]["ms_per_step"] == pytest.approx(3.0)
    assert sum(r["share"] for r in summary["top"]) == pytest.approx(1.0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as cpu:
        torch.ones(4).sum()
    assert trainer_mod.profile_summary(cpu, 1.0, 1)["busy_share"] is None
