"""The port's training path against the JAX package (CPU, tiny widths).

A tiny flagship (nf 16, one encoder and one decoder block, the student's
shared offsets and 8/8/2 samples; the teacher's 8/16/8) at 32x32, with
flax-initialised parameters perturbed by seeded noise, on a seeded batch.

Tolerances:
  * ``train=True``: the frame and the eight flow-pyramid levels within 1e-4
    max abs (``FWD_TOL``), as the forward's own parity test;
  * the distillation loss in fp32: every log value within 1e-5 relative
    (``LOSS_TOL``); every parameter's gradient within 1e-4 of its max abs
    (``GRAD_TOL``: the backward chains some 40 layers, each summing in its
    framework's order), where a gradient below 1% of the largest
    parameter's is held to 1e-4 of that 1% (``FLOOR``: the key
    projections' biases have gradients that are zero in exact arithmetic,
    as the softmax ignores a shift shared by all keys);
  * in bf16 (both sides computing in bf16 over fp32 parameters): the loss
    within half of JAX's own bf16-vs-fp32 gap. For the gradients, JAX's
    bf16 backward sums each bias and weight gradient with bf16
    accumulation (``jax.grad`` of a bf16 bias added to 10,000 ones gives
    4096), where the port's sums run in fp32 and are rounded once: the
    port's bf16 gradient lies closer to the fp32 gradient than JAX's does,
    so it cannot sit within half of JAX's gap from JAX's bf16 gradient.
    Held instead, with the fp32 gradient as the reference: the port's bf16
    gradients within half of JAX's own gap from JAX's fp32 gradients
    (``BF16_GAP_SHARE``; measured 0.300), and no further from JAX's bf16
    gradients than that whole gap (measured 0.864); mean abs over every
    parameter, each normalised by its fp32 max abs, floored as above.
"""

import concurrent.futures
import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization as fser

from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.models import create_model as jax_create_model
from videoframeinterpolation_tpu.models.dat import DATwConstantnC as JaxDAT
from videoframeinterpolation_tpu.train.state import create_train_state as jax_train_state
from videoframeinterpolation_tpu.train.step import make_distill_loss_fn as jax_distill_loss_fn
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.interop import params_from_flax, params_to_flax
from videoframeinterpolation_tpu_torch.models import DATwConstantnC, create_model
from videoframeinterpolation_tpu_torch.tools import head_to_head
from videoframeinterpolation_tpu_torch.train import (
    create_train_state, flax_msgpack_bytes, make_distill_loss_fn, read_flax_state,
    state_from_flax, state_to_flax, write_flax_state)

ROOT = Path(__file__).resolve().parent.parent
STUDENT = (ROOT / "tools" / "quality" / "results"
           / "DATwConstantnCv1_shared_s8-8-2_distill1.0T8-16-8_24k.best.ckpt")
FWD_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
FLOOR = 1e-2
BF16_GAP_SHARE = 0.5
KW = dict(nf=16, enc_res_blocks=1, dec_res_blocks=1, shared_offsets=True, n_samples=(8, 8, 2))
TEACHER_KW = dict(KW, n_samples=(8, 16, 8))
TINY = dict(nf=16, enc_res_blocks=1, dec_res_blocks=1, shared_offsets=True, dat_samples=(8, 8, 2))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch(B=2, H=32, W=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"x0": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
            "x1": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
            "xt": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
            "t": np.full((B, 1, 1, 1), 0.5, np.float32),
            "f0x": (rng.standard_normal((B, H, W, 2)) * 0.02).astype(np.float32),
            "f1x": (rng.standard_normal((B, H, W, 2)) * 0.02).astype(np.float32)}


def _init_args(key):
    """The arguments of a flax initialisation from ``key`` at one 32x32 pair."""
    batch = _batch(B=1)
    return jax.random.key(key), batch["x0"], batch["x1"], batch["t"]


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)


def _distill_loss(dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else None
    loss_fn = jax_distill_loss_fn(JaxDAT(**KW, dtype=jdt), JaxDAT(**TEACHER_KW, dtype=jdt),
                                  JaxConfig(model_name="DATwConstantnCv1", nf=16), 1.0)
    return jax.value_and_grad(loss_fn, has_aux=True)


@pytest.fixture(scope="module")
def jax_calls():
    """The jitted JAX calls of this file: the student's flax initialisation
    from key 0 and the teacher's from key 1 (their values), and, traced
    against their parameters' shapes while those compile, the student's
    ``train=True`` forward and the distillation loss's value and gradient
    in fp32 and in bf16, each compiled in a thread of its own."""
    x0, x1, t = (_batch()[k] for k in ("x0", "x1", "t"))
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        inits = [jax.jit(JaxDAT(**kw).init).lower(*_init_args(key))
                 for kw, key in ((KW, 0), (TEACHER_KW, 1))]
        compiled = [pool.submit(low.compile) for low in inits]
        params, t_params = (low.out_info for low in inits)
        for fn, args in ((lambda p: JaxDAT(**KW).apply(p, x0, x1, t, train=True), (params,)),
                         (_distill_loss(torch.float32), (params, t_params, _batch())),
                         (_distill_loss(torch.bfloat16), (params, t_params, _batch()))):
            compiled.append(pool.submit(jax.jit(fn).lower(*args).compile))
        init, t_init, fwd, fp32, bf16 = (c.result() for c in compiled)
    return {"inits": [init(*_init_args(0)), t_init(*_init_args(1))], "forward": fwd,
            torch.float32: fp32, torch.bfloat16: bf16}


@pytest.fixture(scope="module")
def student_init(jax_calls):
    return jax_calls["inits"][0]


@pytest.fixture(scope="module")
def setup(jax_calls):
    batch = _batch()
    params = _perturbed(jax_calls["inits"][0], 2)
    t_params = _perturbed(jax_calls["inits"][1], 3)
    return batch, params, t_params


def _jax_distill(jax_calls, batch, params, t_params, dtype):
    (_, log), grads = jax_calls[dtype](params, t_params, batch)
    return {k: float(v) for k, v in log.items()}, grads


@pytest.fixture(scope="module")
def jax_fp32(setup, jax_calls):
    return _jax_distill(jax_calls, *setup, torch.float32)


def _port_distill(batch, params, t_params, dtype):
    model = DATwConstantnC(**KW, compute_dtype=dtype)
    model.load_state_dict(params_from_flax(params, model))
    teacher = DATwConstantnC(**TEACHER_KW, compute_dtype=dtype)
    teacher.load_state_dict(params_from_flax(t_params, teacher))
    teacher = teacher.to(dtype).eval()   # served: parameters cast once
    loss_fn = make_distill_loss_fn(model, teacher, Config(nf=16), 1.0)
    total, log = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    return model, {k: v.item() for k, v in log.items()}


def test_train_intermediates_match_jax(setup, jax_calls):
    batch, params, _ = setup
    x0, x1, t = batch["x0"], batch["x1"], batch["t"]
    ref_pred, ref_inter = jax_calls["forward"](params)
    model = DATwConstantnC(**KW)
    model.load_state_dict(params_from_flax(params, model))
    with torch.no_grad():
        pred, inter = model(torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(t),
                            train=True)
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref_pred), rtol=0, atol=FWD_TOL)
    assert set(inter) == set(ref_inter) == {"pred_ft0", "pred_ft1"}
    for key in inter:
        assert [tuple(a.shape) for a in inter[key]] == [(2, 32, 32, 2)] * 4
        for got, ref in zip(inter[key], ref_inter[key]):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=FWD_TOL)


def test_distill_loss_and_every_gradient_match_jax_in_fp32(setup, jax_fp32):
    ref_log, ref_grads = jax_fp32
    model, log = _port_distill(*setup, torch.float32)
    assert set(log) == set(ref_log) == {"l1_loss", "census_loss", "flow_loss", "teacher_loss",
                                        "total_loss"}
    for k, v in log.items():
        assert abs(v - ref_log[k]) <= LOSS_TOL * abs(ref_log[k]), k
    ref = params_from_flax(ref_grads, model)
    largest = max(r.abs().max().item() for r in ref.values())
    worst = 0.0
    for name, p in model.named_parameters():
        scale = max(ref[name].abs().max().item(), FLOOR * largest)
        err = (p.grad - ref[name]).abs().max().item()
        worst = max(worst, err / scale)
        assert err <= GRAD_TOL * scale, f"{name}: {err} > {GRAD_TOL} x {scale}"
    print(f"fp32 gradients: largest error {worst:.3e} of the (floored) max abs")


def test_distill_gradients_in_bf16_against_jaxs_own_gap(setup, jax_calls, jax_fp32):
    ref32_log, ref32 = jax_fp32
    ref16_log, ref16 = _jax_distill(jax_calls, *setup, torch.bfloat16)
    model, log = _port_distill(*setup, torch.bfloat16)
    loss_gap = abs(ref16_log["total_loss"] - ref32_log["total_loss"])
    assert abs(log["total_loss"] - ref16_log["total_loss"]) <= 0.5 * loss_gap
    g32, g16 = params_from_flax(ref32, model), params_from_flax(ref16, model)
    largest = max(r.abs().max().item() for r in g32.values())
    vs16 = vs32 = gap = 0.0
    for name, p in model.named_parameters():
        scale = max(g32[name].abs().max().item(), FLOOR * largest)
        g = p.grad.double()
        vs16 += (g - g16[name].double()).abs().mean().item() / scale
        vs32 += (g - g32[name].double()).abs().mean().item() / scale
        gap += (g16[name].double() - g32[name].double()).abs().mean().item() / scale
    print(f"bf16 gradients: port vs JAX bf16 {vs16 / gap:.3f}, port vs JAX fp32 "
          f"{vs32 / gap:.3f} of JAX's own bf16-vs-fp32 gap")
    assert vs32 <= BF16_GAP_SHARE * gap
    assert vs16 <= gap


def test_init_follows_the_jax_rules(student_init):
    """Each parameter is drawn by its JAX counterpart's rule: the same zeros
    (biases, the offset and mask predictors), PReLU at 0.25, and the same
    spread (std within 20% for every kernel of 1,000 or more values)."""
    ref = params_from_flax(student_init, DATwConstantnC(**KW))
    torch.manual_seed(0)
    model = DATwConstantnC(**KW)
    for name, p in model.named_parameters():
        r = ref[name]
        assert torch.equal(p == 0, r == 0) or (p != 0).all() == (r != 0).all(), name
        if name.endswith("alpha"):
            assert torch.equal(p, r), name
        if r.numel() >= 1000 and r.std() > 0:
            assert 0.8 <= (p.std() / r.std()).item() <= 1.25, name
    zero = ("conv_res_offset", "om_out")
    assert all(not p.any() for n, p in model.named_parameters() if any(z in n for z in zero))
    assert all(not p.any() for n, p in model.named_parameters() if n.endswith("bias"))


def test_port_written_checkpoint_restores_in_flax(tmp_path, student_init):
    """A port TrainState written by ``write_flax_state`` is restored by
    ``flax.serialization.from_bytes`` into the JAX package's TrainState of
    the same model, leaf for leaf."""
    cfg = dataclasses.replace(Config(), compute_dtype="float32", **TINY)
    torch.manual_seed(1)
    state = create_train_state(create_model(cfg, torch.float32), cfg)
    gen = torch.Generator().manual_seed(2)
    for moments in (state.opt_state.exp_avg, state.opt_state.exp_avg_sq):
        for t in moments.values():
            t.copy_(torch.rand(t.shape, generator=gen))
    state.step = state.opt_state.count = state.opt_state.schedule_count = 37
    path = tmp_path / "port.ckpt"
    write_flax_state(path, state_to_flax(state))

    jcfg = JaxConfig(model_name="DATwConstantnCv1", compute_dtype="float32", **TINY)
    jmodel = jax_create_model(jcfg)
    # The config's model is the student: its initialisation is the template.
    assert jmodel == JaxDAT(**KW)
    restored = fser.from_bytes(jax_train_state(jmodel, student_init, jcfg), path.read_bytes())
    assert int(restored.step) == 37
    assert int(restored.opt_state[0].count) == int(restored.opt_state[2].count) == 37
    ours = state_to_flax(state)
    for got, want in ((restored.params, ours["params"]),
                      (restored.opt_state[0].mu, ours["opt_state"]["0"]["mu"]),
                      (restored.opt_state[0].nu, ours["opt_state"]["0"]["nu"])):
        pairs = jax.tree_util.tree_leaves_with_path(got)
        assert len(pairs) == len(jax.tree_util.tree_leaves(want))
        for path_, leaf in pairs:
            node = want
            for k in path_:
                node = node[k.key]
            assert np.array_equal(np.asarray(leaf), node), path_


def test_committed_checkpoint_round_trips_through_the_port():
    """The shipped student's TrainState read, loaded into a port train
    state, written back: the same bytes as the committed file (so the
    parameter and moment maps and the msgpack encoder are exact)."""
    tree = read_flax_state(STUDENT)
    assert flax_msgpack_bytes(tree) == STUDENT.read_bytes()
    from videoframeinterpolation_tpu_torch.config import DAT_fast
    state = create_train_state(create_model(DAT_fast, torch.float32), DAT_fast)
    state_from_flax(tree, state)
    assert (state.step, state.opt_state.count, state.opt_state.schedule_count) == (14500,) * 3
    assert flax_msgpack_bytes(state_to_flax(state)) == STUDENT.read_bytes()


@pytest.mark.parametrize("step0", [0, 3, 14500])
def test_resumed_sampler_stream_equals_head_to_head(step0):
    """``batch_sampler`` after a resume at ``step0`` draws the indices the
    JAX tool draws (its inline loop, ``tools/quality/head_to_head.py``)."""
    seed, pool, batch = 42, 768, 8
    ref = np.random.Generator(np.random.PCG64(seed + 777))
    for _ in range(step0):
        ref.integers(0, pool, size=batch)
    ours = head_to_head.batch_sampler(seed, pool, batch, step0)
    for _ in range(25):
        np.testing.assert_array_equal(ours.integers(0, pool, size=batch),
                                      ref.integers(0, pool, size=batch))


TINY_ARGS = ["--model", "DATwConstantnCv1", "--shared", "--samples", "8,8,2", "--nf", "16",
             "--crop", "32", "--pool", "4", "--eval_items", "2", "--batch", "2", "--steps", "2",
             "--chunk", "1", "--eval_every", "1", "--warmup", "1", "--device", "cpu"]


def test_entry_point_trains_two_steps_on_the_cpu(tmp_path):
    """Two steps of the trainer with a teacher: the JAX tool's tag, events
    and files; the written checkpoint holds the in-memory state (step 2);
    a run stopped at step 1 and resumed ends with the same bytes."""
    teacher = tmp_path / "teacher.ckpt"
    # The trainer builds nf-wide models at the recipe's depth (5 and 10 blocks).
    cfg = dataclasses.replace(Config(), nf=16, shared_offsets=True, dat_samples=(8, 16, 8))
    torch.manual_seed(3)
    write_flax_state(teacher, state_to_flax(create_train_state(create_model(cfg, torch.float32),
                                                                cfg)))
    distill = ["--distill_from", str(teacher), "--teacher_shared", "--teacher_samples", "8,16,8",
               "--distill_w", "1.0"]
    out = head_to_head.main(TINY_ARGS + distill + ["--out_dir", str(tmp_path / "a")])
    tag = "DATwConstantnCv1_shared_s8-8-2_distill1.0T8-16-8_nf16_0k"
    assert out["tag"] == tag
    events = [r["event"] for r in out["records"]]
    assert events == ["start", "eval", "eval", "final"]
    assert all(np.isfinite(r["train_loss"]) for r in out["records"] if r["event"] == "eval")
    lines = (tmp_path / "a" / f"{tag}.jsonl").read_text().splitlines()
    assert len(lines) == 4
    ckpt = tmp_path / "a" / f"{tag}.ckpt"
    assert int(read_flax_state(ckpt)["step"]) == 2
    assert (tmp_path / "a" / f"{tag}.best.ckpt").is_file()

    b = str(tmp_path / "b")
    head_to_head.main(TINY_ARGS + distill + ["--out_dir", b, "--stop_at", "1"])
    resumed = head_to_head.main(TINY_ARGS + distill + ["--out_dir", b, "--resume"])
    assert [r["event"] for r in resumed["records"]] == ["resume", "eval", "final"]
    assert resumed["records"][0]["step"] == 1
    assert (Path(b) / f"{tag}.ckpt").read_bytes() == ckpt.read_bytes()


def test_out_dir_has_no_default():
    with pytest.raises(SystemExit):
        head_to_head.parse_args(TINY_ARGS)
