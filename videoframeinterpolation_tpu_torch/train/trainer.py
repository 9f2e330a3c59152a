"""The production trainer (counterpart of ``videoframeinterpolation_tpu/train/trainer.py``).

:class:`Trainer` runs the JAX trainer's loop: per epoch the loader's
shuffle (``set_epoch``) and the dataset's generator
(``seed * 100003 + epoch``) are re-seeded; each step trains on one batch
(:func:`.step.train_step`: forward, loss, backward, one AdamW update) and
logs the loss terms, the learning rate of the step (``warmup_cosine_lr(step
- 1)``), ``data_time`` and ``train_time``; image summaries, ``latest``,
``epoch_XXX`` and validation with ``best_<benchmark>`` follow the config's
cadences, and a preemption signal saves ``latest`` and returns. With
``teacher_ckpt`` the student trains against the frozen teacher built from
``teacher_overrides`` (``make_distill_loss_fn``).

Where the port differs, by design:
  * the step's log values come to the host in one transfer (the JAX loop
    reads each with ``float()``, which on the card would wait once per key);
  * a run resumed mid-epoch skips the batches its epoch had already taken
    (it still loads them, so the dataset's generator advances as in an
    uninterrupted run), where the JAX loop trains the preempted epoch again
    from its start; with ``num_workers=1`` a resumed run is bit-equal to an
    uninterrupted one on the CPU;
  * validation and image summaries run the model in the training config's
    dtype (bf16 for the flagship), as the JAX trainer's ``_inference_fn``
    does; ``evaluate.py`` scores in fp32;
  * ``profile_steps`` traces with ``torch.profiler`` into
    ``<log_dir>/profile`` (a Chrome trace and ``summary.json``: the
    device's busy share of the traced steps and its top operations);
  * data parallelism is one process per card (:mod:`..parallel.ddp`); only
    rank 0 writes logs and checkpoints, and every rank validates.

The model and its parameters start from the port's initialisation under
``torch.manual_seed(cfg.seed)`` (flax's initialiser is not reproduced).
Each entry runs on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..data import DATASET_REGISTRY, DataLoader
from ..eval.benchmarks import (validate_snu, validate_synthetic, validate_ucf101,
                               validate_vimeo90k)
from ..interop import params_from_flax
from ..interpolate import resolve_device
from ..models import create_model
from ..parallel import ddp
from ..utils.flow_viz import flow_to_image
from ..utils.logger import Logger
from .checkpoint import CheckpointManager, restore_teacher_params
from .preemption import PreemptionGuard
from .schedule import warmup_cosine_lr
from .state import create_train_state, state_from_flax, state_to_flax
from .step import make_distill_loss_fn, make_loss_fn, train_step


def build_dataset(cfg: Config, is_train: bool = True):
    """The config's dataset (``DATASET_REGISTRY[cfg.data_name]``)."""
    cls = DATASET_REGISTRY[cfg.data_name]
    kwargs = dict(root=cfg.root, crop_hw=(cfg.crop_h, cfg.crop_w), is_train=is_train,
                  seed=cfg.seed)
    if cfg.data_name == "Vimeo90KwFlow":
        kwargs.update(flow_dir=cfg.flow_dir, distill_bwd=cfg.distill_bwd)
    return cls(**kwargs)


def device_events(prof) -> list:
    """The traced device operations (kernels, copies, sets) as the profiler
    recorded them, read from its raw results: building its Python event
    tree (``prof.events()``, ``key_averages()``) costs seconds for one
    training step's trace."""
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation() and e.duration_ns() > 0]


def _union_ms(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def profile_summary(prof, wall_ms: float, steps: int, top: int = 15) -> dict:
    """The device's busy share of ``wall_ms`` (the union of its operations'
    intervals, so overlapping streams count once) and its top operations
    by total time, per step; ``None`` where the trace holds no device
    operation (a run on the CPU)."""
    events = device_events(prof)
    busy = _union_ms([(e.start_ns() / 1e6, e.end_ns() / 1e6) for e in events]) if events else None
    by_name: dict[str, list] = {}
    for e in events:
        row = by_name.setdefault(e.name(), [0, 0.0])
        row[0] += 1
        row[1] += e.duration_ns() / 1e6
    ops = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    total = sum(ms for _, ms in by_name.values())
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": None if busy is None else busy / steps,
            "busy_share": None if busy is None else busy / wall_ms,
            "top": [{"op": name[:120], "ms_per_step": ms / steps, "calls_per_step": n / steps,
                     "share": ms / total if total else 0.0}
                    for name, (n, ms) in ops[:top]]}


class Trainer:
    def __init__(self, cfg: Config, device: str | torch.device = "cuda",
                 world: ddp.World | None = None):
        self.cfg = cfg
        self.world, self.device = ddp.init(resolve_device(device), world or ddp.World(0, 1, 0))
        if self.device.type == "cuda":
            # fp32 configs compute in full fp32 on the card, as on the CPU.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        torch.manual_seed(cfg.seed)
        model = create_model(cfg, torch.float32).to(self.device)
        self.state = create_train_state(model, cfg)
        self.num_params = sum(p.numel() for p in model.parameters())
        # What the loss calls: the model, or its DDP wrapper.
        self.model = ddp.wrap(model, self.world, self.device)
        if cfg.teacher_ckpt:
            t_cfg = (dataclasses.replace(cfg, **cfg.teacher_overrides)
                     if cfg.teacher_overrides else cfg)
            # Parameters rounded once to the compute dtype: the values flax
            # casts to at every call.
            teacher = create_model(t_cfg)
            teacher.load_state_dict(params_from_flax(restore_teacher_params(cfg.teacher_ckpt),
                                                     teacher))
            self.teacher = teacher.to(self.device).eval().requires_grad_(False)
            self.loss_fn = make_distill_loss_fn(self.model, self.teacher, cfg,
                                                cfg.distill_teacher_w)
        else:
            self.teacher = None
            self.loss_fn = make_loss_fn(self.model, cfg)
        self.ckpt = CheckpointManager(cfg.log_dir, create=self.world.is_main)
        self.logger = (Logger(cfg.log_dir, cfg.metric_summary_freq) if self.world.is_main
                       else None)
        self.epoch = 0
        self.best_psnr = 0.0
        self.profile: dict | None = None

    # ------------------------------------------------------------------ #

    def resume(self, name: str = "latest") -> bool:
        if not self.ckpt.exists(name):
            return False
        tree, meta = self.ckpt.restore(name)
        state_from_flax(tree, self.state)
        self.epoch = meta["epoch"]
        self.best_psnr = meta["best_psnr"]
        if self.logger is not None:
            self.logger.total_steps = meta["step"]
        print(f"resumed from {name}: step={meta['step']} epoch={self.epoch}")
        return True

    def validate(self) -> dict:
        """The benchmark loops of ``cfg.val_datasets`` on the model as it
        trains, in the training config's dtype."""
        cfg, model = self.cfg, self.state.model
        model.eval()
        kw = dict(device=self.device)
        results = {}
        try:
            if "vimeo90k" in cfg.val_datasets:
                results.update(validate_vimeo90k(model, cfg.root, **kw))
            if "ucf101" in cfg.val_datasets:
                results.update(validate_ucf101(model, root=cfg.ucf101_root, **kw))
            if "snu" in cfg.val_datasets:
                results.update(validate_snu(model, root=cfg.snu_root, **kw))
            if "synthetic" in cfg.val_datasets:
                results.update(validate_synthetic(model, seed=cfg.seed,
                                                  hw=(cfg.crop_h, cfg.crop_w), **kw))
        finally:
            model.train()
        return results

    # ------------------------------------------------------------------ #

    def train(self, profile_steps: tuple[int, int] | None = None,
              preemption_guard: PreemptionGuard | None = None) -> None:
        """Run the training loop.

        Args:
          profile_steps: optional ``(start, stop)`` step interval traced
            with ``torch.profiler`` into ``<log_dir>/profile``; its summary
            is also kept in ``self.profile``.
          preemption_guard: SIGTERM-to-flag bridge; a default one is
            installed when None. On preemption the loop finishes the step
            in flight, saves ``latest`` and returns.
        """
        guard = preemption_guard or PreemptionGuard()
        with guard:
            self._train_loop(profile_steps, guard)

    def _save(self, name: str, epoch: int) -> None:
        if self.world.is_main:
            self.ckpt.save(name, state_to_flax(self.state), epoch=epoch,
                           best_psnr=self.best_psnr)

    def _train_loop(self, profile_steps, guard: PreemptionGuard) -> None:
        cfg, world = self.cfg, self.world
        if world.is_main:
            Path(cfg.log_dir).mkdir(parents=True, exist_ok=True)
            cfg.save_yaml(Path(cfg.log_dir) / "config.yaml")
        print(f"model {cfg.model_name}: {self.num_params} params, {world.size} devices")

        dataset = build_dataset(cfg, is_train=True)
        loader = DataLoader(dataset, cfg.batch_size, shuffle=True, drop_last=True,
                            num_workers=cfg.num_workers, seed=cfg.seed,
                            shard_index=world.rank, num_shards=world.size)
        steps_per_epoch = len(loader)
        step = self.state.step
        prof = None
        for epoch in range(self.epoch, cfg.num_epochs):
            loader.set_epoch(epoch)
            dataset.seed(cfg.seed * 100003 + epoch)
            # Batches of this epoch that a resumed run has already taken.
            done = min(max(step - epoch * steps_per_epoch, 0), steps_per_epoch)
            t_data = time.time()
            for i, batch in enumerate(loader):
                if i < done:
                    t_data = time.time()
                    continue
                data_time = time.time() - t_data
                t_train = time.time()

                if profile_steps is not None and step == profile_steps[0]:
                    prof, t_prof = self._start_profile()
                on_device = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
                log = train_step(self.state, self.loss_fn, on_device)
                step += 1
                # The log values and this rank's preemption flag, averaged
                # over the ranks, in one transfer to the host.
                flag = torch.tensor(float(guard.preempted), device=self.device)
                values = ddp.mean_over_world(
                    torch.stack([v.float() for v in log.values()] + [flag]), world).tolist()
                preempted = values.pop() > 0
                if prof is not None and step == profile_steps[1]:
                    self._stop_profile(prof, t_prof, step - profile_steps[0])
                    prof = None

                metrics = dict(zip(log, values))
                metrics.update({
                    "lr": float(warmup_cosine_lr(step - 1, cfg.start_lr, cfg.end_lr,
                                                 cfg.last_lr_decay_iter, cfg.warmup_steps)),
                    "data_time": data_time,
                    "train_time": time.time() - t_train,
                })
                if self.logger is not None:
                    self.logger.push(metrics)
                    if step % cfg.img_summary_freq == 0:
                        self._log_images(batch)

                if step % cfg.save_latest_freq == 0:
                    self._save("latest", epoch)

                if preempted:
                    self._save("latest", epoch)
                    print(f"preemption signal: saved 'latest' at step {step} "
                          f"(epoch {epoch}); exiting cleanly")
                    return
                t_data = time.time()

            if (epoch + 1) % cfg.save_every_freq_epoch == 0:
                self._save(f"epoch_{epoch + 1:03d}", epoch + 1)

            if (epoch + 1) % cfg.valid_freq_epoch == 0 and cfg.val_datasets:
                results = self.validate()
                key = f"val/{cfg.save_best_benchmark}_psnr"
                cur = results.get(key, 0.0)
                if cur > self.best_psnr:
                    self.best_psnr = cur
                    self._save(f"best_{cfg.save_best_benchmark}", epoch + 1)
                if self.logger is not None:
                    self.logger.write_dict(results, step=epoch + 1)
                print(f"Epoch {epoch + 1} Validation Done - Best: {self.best_psnr:.3f}")

    # ------------------------------------------------------------------ #

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        prof = torch.profiler.profile(activities=activities)
        start = time.perf_counter()
        prof.start()
        self._profiler_seconds = {"start": time.perf_counter() - start}
        return prof, time.perf_counter()

    def _stop_profile(self, prof, t0: float, steps: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        # The profiler's own cost on the host (start, stop, the summary and
        # the trace's export), which the traced steps' train_time includes.
        seconds = self._profiler_seconds
        start = time.perf_counter()
        prof.stop()
        seconds["stop"] = time.perf_counter() - start
        self.profile = profile_summary(prof, wall_ms, steps)
        seconds["summary"] = time.perf_counter() - start - seconds["stop"]
        if self.world.is_main:
            out = Path(self.cfg.log_dir) / "profile"
            out.mkdir(parents=True, exist_ok=True)
            start = time.perf_counter()
            prof.export_chrome_trace(str(out / "trace.json"))
            seconds["export"] = time.perf_counter() - start
        self.profile["profiler_seconds"] = seconds
        if self.world.is_main:
            (out / "summary.json").write_text(json.dumps(self.profile, indent=1))

    @staticmethod
    def _flow_strip(flows, full_hw: tuple[int, int]) -> np.ndarray:
        """Render ``(H', W', 2)`` flow maps side by side at full resolution
        (nearest upscale; visualisation only)."""
        H, W = full_hw
        panels = []
        for f in flows:
            img = flow_to_image(np.asarray(f, np.float32))
            ry, rx = H // img.shape[0], W // img.shape[1]
            if ry > 1 or rx > 1:
                img = np.repeat(np.repeat(img, ry, axis=0), rx, axis=1)
            panels.append(img[:H, :W])
        return np.concatenate(panels, axis=1)

    def _log_images(self, batch: dict) -> None:
        """Prediction strip ``[avg | pred | gt | err]`` and the 10-panel flow
        pyramid ``[ft0_4..ft0_1 | pseudo-GT ft0, ft1 | ft1_1..ft1_4]``
        (reference ``models/DAT.py:40-72``; the pseudo-GT pair alone for a
        model without ``pred_ft0``), of the batch's first item."""
        try:
            x0, x1, t = (torch.from_numpy(batch[k][:1]).to(self.device)
                         for k in ("x0", "x1", "t"))
            H, W = x0.shape[1], x0.shape[2]
            with torch.no_grad():
                pred, inter = self.state.model(x0, x1, t, train=True)
            pred = pred.float().cpu().numpy()[0]
            x0n, x1n = batch["x0"][0], batch["x1"][0]
            xt = batch["xt"][0]
            panels = {"pred": np.concatenate([(x0n + x1n) / 2, pred, xt, np.abs(xt - pred)],
                                             axis=1)}
            if "f0x" in batch:
                p0, p1 = inter.get("pred_ft0", []), inter.get("pred_ft1", [])
                flows = ([f[0].float().cpu().numpy() for f in reversed(p0)]
                         + [batch["f0x"][0], batch["f1x"][0]]
                         + [f[0].float().cpu().numpy() for f in p1])
                panels["flow"] = self._flow_strip(flows, (H, W))
            self.logger.add_image_summary(panels)
        except Exception:   # logging must never kill training
            print(f"image summary failed:\n{traceback.format_exc()}")

    def close(self) -> None:
        """Close the log and leave the process group."""
        if self.logger is not None:
            self.logger.close()
        ddp.shutdown(self.world)
