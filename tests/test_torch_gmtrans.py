"""GMTrans and the forward warp in the port against the JAX package (CPU, narrow widths), and its entry points on ``configs/archive/GMTrans.yaml``.

The splat ops (``ops/softsplat.py``, ``ops/warp.py``) on flows that
collide and leave the frame; the window, mask and correlation helpers and
the feature transformer (``nn/transformer.py``); and a tiny GMTrans (nf
24, pyramid 12/12/24, two transformer layers; the decoders keep their
fixed depth of 6) on two 64x64 pairs. The tiny model's parameters are the
port's initialisation plus seeded noise of scale 0.05, with every
LayerNorm scale at 0.03 of its value and the encoder's kernels doubled.
With the LayerNorm scales at 1 the model is chaotic in bf16 (JAX's own
frame moves by 0.43-0.85 of its bf16-vs-fp32 gap when the input moves by
1e-6, four parameter seeds): its 1/8 flows are softmax-weighted averages
of the pixel grid over a nearly flat correlation whose common part
dwarfs its spread, rounded to bf16 and magnified 8x. At 0.03 the
residual streams carry the encoder's content; doubling the encoder makes
the certainty vary over the frame (from 0.83 to 1 minus the peak), so
that ``alpha`` gets a gradient. JAX's own move is then 0.17-0.24 of its
gap (the port 0.15-0.18 from JAX's frame; three seeds). The parameters
are written by the port's checkpoint writer
and read by JAX (no flax ``init`` runs). Every JAX call is jitted once,
and the calls of each fixture are compiled side by side.

Tolerances:
  * the splats: fp32 within 1e-6 of the output's (or each gradient's)
    max abs (XLA's ``exp`` is an approximation of its own); bf16 bit for
    bit (an accumulating ``index_put_`` adds in index order, rounding each
    add, as XLA's CPU scatter-add does); the hole masks equal;
  * the window helpers and the shift mask: equal;
  * the correlation and the feature transformer: fp32 within 1e-5 of
    each output's max abs (measured: 1.5e-6 to 2.8e-6; the LayerNorms'
    fast variance cancels, four deep); bf16 mean abs within
    half of JAX's own bf16-vs-fp32 gap (the two frameworks' fp32 sums,
    ``exp`` and ``erfc`` differ in the last bit, and a rare flip of a
    bf16 rounding spreads through attention);
  * the model: fp32 within 1e-3 max abs and 1e-5 mean abs (the frame and
    the intermediates ``base``, ``pred_f01``, ``pred_f10``); bf16 mean
    abs at most half of JAX's own gap;
  * the loss: each log term within 1e-5 relative, the whole gradient
    within 1e-4 relative in L2, and ``alpha``'s alone within 1e-4;
  * the flax round trip: exact.
"""

import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

from torch_tiny import compile_side_by_side, run_in, smooth_pair
from videoframeinterpolation_tpu.config import Config as JaxConfig
from videoframeinterpolation_tpu.models import create_model as jax_create_model
from videoframeinterpolation_tpu.models.gmtrans import GMTrans as JaxGMTrans
from videoframeinterpolation_tpu.models.gmtrans import gmtrans_loss as jax_gmtrans_loss
from videoframeinterpolation_tpu.nn import transformer as jax_transformer
from videoframeinterpolation_tpu_torch import evaluate, interpolate
from videoframeinterpolation_tpu_torch.config import Config
from videoframeinterpolation_tpu_torch.interop import params_from_flax, params_to_flax
from videoframeinterpolation_tpu_torch.models import GMTrans, create_model, multi_t_apply
from videoframeinterpolation_tpu_torch.nn import transformer
from videoframeinterpolation_tpu_torch.ops import (fwarp, fwarp_mframes, fwarp_using_two_frames,
                                                   softsplat, softsplat_raw)
from videoframeinterpolation_tpu_torch.tools import fixtures
from videoframeinterpolation_tpu_torch.train import (create_train_state, make_loss_fn,
                                                     read_flax_msgpack, state_to_flax,
                                                     write_flax_state)
from videoframeinterpolation_tpu_torch.train import __main__ as train_cli
from videoframeinterpolation_tpu_torch.train.trainer import build_dataset
from videoframeinterpolation_tpu_torch.utils import logger as port_logger

# The ops modules by path: the JAX package's ops/__init__.py binds the
# names ``softsplat`` and ``warp`` to functions.
jax_softsplat = importlib.import_module("videoframeinterpolation_tpu.ops.softsplat")
jax_warp = importlib.import_module("videoframeinterpolation_tpu.ops.warp")

ROOT = Path(__file__).resolve().parent.parent
YAML = ROOT / "configs" / "archive" / "GMTrans.yaml"
KW = dict(nf=24, pyramid=(12, 12, 24), num_transformer_layers=2)
NOISE = 0.05
NORM_SCALE = 0.03
ENC_GAIN = 2.0
B, H, W = 2, 64, 64
SPLAT_TOL = 1e-6
BLOCK_TOL = 1e-5
MAX_TOL = 1e-3
MEAN_TOL = 1e-5
BF16_GAP_SHARE = 0.5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODES = ("sum", "avg", "linear", "soft", "soft-zeroeps", "soft-clipeps", "linear-zeroeps",
         "avg-clipeps")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _torch(a, dtype="float32"):
    """``a`` (numpy or JAX) as a torch tensor of ``dtype``, through fp32."""
    return torch.tensor(np.asarray(a, np.float32)).to(DTYPES[dtype][1])


def _np(t):
    return t.detach().float().numpy()


def _within(got, want, tol):
    return np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max() <= tol


# ---------------------------------------------------------------------------
# The splat ops.

def _splat_inputs(seed=0, b=2, h=12, w=16, c=5):
    """Values, flows of a few pixels down (so that taps collide and the top
    rows get none) with some far outside the frame and some on whole
    pixels, and metrics."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    flow = (rng.normal(size=(b, h, w, 2)) * 3).astype(np.float32)
    flow[..., 1] += 5.0          # downwards: the top rows stay holes
    flow[0, :2, :3] = 100.0
    flow[1, -2:, -3:] = -60.0
    flow[0, 5, :] = np.round(flow[0, 5, :])
    metric = (rng.normal(size=(b, h, w, 1)) * 3).astype(np.float32)
    return x, flow, metric


def _jax_splats(x, flow, metric, dtype):
    """Every splat of this file's cases in one program: ``softsplat_raw``,
    each mode of ``MODES``, ``fwarp_using_two_frames`` and
    ``fwarp_mframes`` (three branches)."""
    b = x.shape[0]
    t = jnp.asarray(np.array([0.3, 0.7], np.float32)[:b].reshape(b, 1, 1, 1), dtype)
    raw = jax_softsplat.softsplat_raw(x, flow)
    modes = [jax_softsplat.softsplat(x, flow, metric if m.split("-")[0] in ("linear", "soft")
                                     else None, m) for m in MODES]
    x1, flow1, metric1 = x[::-1], flow[::-1], metric[::-1]
    two = jax_warp.fwarp_using_two_frames(x, flow, t, x1, flow1, 1.0 - t, metric, metric1)
    flows = jnp.stack([flow, 0.5 * flow, jnp.round(flow)])
    ts = jnp.stack([t, 0.5 * t, 1.0 - t])
    mframes = jax_warp.fwarp_mframes(x, flows, ts, x1, flows[:, ::-1], 1.0 - ts, metric,
                                     metric1)
    return raw, modes, two, mframes


def _port_splats(x, flow, metric):
    b = x.shape[0]
    t = torch.tensor([0.3, 0.7])[:b].reshape(b, 1, 1, 1).to(x.dtype)
    raw = softsplat_raw(x, flow)
    modes = [fwarp(x, flow, metric if m.split("-")[0] in ("linear", "soft") else None, m)
             for m in MODES]
    x1, flow1, metric1 = x.flip(0), flow.flip(0), metric.flip(0)
    two = fwarp_using_two_frames(x, flow, t, x1, flow1, 1.0 - t, metric, metric1)
    flows = torch.stack([flow, 0.5 * flow, torch.round(flow)])
    ts = torch.stack([t, 0.5 * t, 1.0 - t])
    mframes = fwarp_mframes(x, flows, ts, x1, flows.flip(1), 1.0 - ts, metric, metric1)
    return raw, modes, two, mframes


def _splat_grads(x, flow, metric, ct):
    """The fp32 gradients of ``softsplat_raw`` (``x``, ``flow``) and of
    ``fwarp_using_two_frames``'s frame (``x``, ``flow``, ``metric``)
    against the cotangent ``ct``."""
    t = jnp.full((x.shape[0], 1, 1, 1), 0.4, jnp.float32)

    def raw(a, f):
        return jnp.sum(jax_softsplat.softsplat_raw(a, f) * ct)

    def two(a, f, m):
        out, _ = jax_warp.fwarp_using_two_frames(a, f, t, a[::-1], -f[::-1], 1.0 - t, m,
                                                 m[::-1])
        return jnp.sum(out * ct)

    return jax.grad(raw, (0, 1))(x, flow), jax.grad(two, (0, 1, 2))(x, flow, metric)


@pytest.fixture(scope="module")
def splat_case():
    """The inputs, a cotangent, and JAX's splats in fp32 and bf16 and its
    fp32 gradients, compiled side by side."""
    x, flow, metric = _splat_inputs()
    ct = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    inputs = {d: [jnp.asarray(a, DTYPES[d][0]) for a in (x, flow, metric)] for d in DTYPES}
    calls = compile_side_by_side(
        (lambda a, f, m: _jax_splats(a, f, m, jnp.float32), inputs["float32"]),
        (lambda a, f, m: _jax_splats(a, f, m, jnp.bfloat16), inputs["bfloat16"]),
        (lambda a, f, m: _splat_grads(a, f, m, ct), inputs["float32"]))
    ref = {d: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), call(*inputs[d]))
           for d, call in zip(DTYPES, calls)}
    grads = jax.tree_util.tree_map(np.asarray, calls[2](*inputs["float32"]))
    return inputs, ct, ref, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softsplat_raw_and_its_modes_match_jax(splat_case, dtype):
    """``softsplat_raw`` and ``softsplat`` in every mode and eps variant:
    fp32 within 1e-6 of each output's max abs, bf16 bit for bit."""
    inputs, _, ref, _ = splat_case
    with torch.no_grad():
        raw, modes, _, _ = _port_splats(*[_torch(a, dtype) for a in inputs[dtype]])
    want_raw, want_modes, _, _ = ref[dtype]
    assert raw.dtype == DTYPES[dtype][1] and tuple(raw.shape) == want_raw.shape
    for mode, got, want in [("raw", raw, want_raw)] + list(zip(MODES, modes, want_modes)):
        if dtype == "float32":
            assert _within(_np(got), want, SPLAT_TOL * np.abs(want).max()), mode
        else:
            assert np.array_equal(_np(got), want), mode
    # Taps land: far flows drop theirs, the rest collide.
    assert 0 < np.count_nonzero(want_raw[..., 0]) < want_raw[..., 0].size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_frame_and_multi_branch_merges_match_jax(splat_case, dtype):
    """``fwarp_using_two_frames`` and ``fwarp_mframes`` (three branches
    folded into the batch): the frame to the splat tolerance, the hole
    masks equal and not empty."""
    inputs, _, ref, _ = splat_case
    with torch.no_grad():
        _, _, two, mframes = _port_splats(*[_torch(a, dtype) for a in inputs[dtype]])
    _, _, want_two, want_m = ref[dtype]
    for (frame, holes), (want, want_holes) in ((two, want_two), (mframes, want_m)):
        if dtype == "float32":
            assert _within(_np(frame), want, SPLAT_TOL * np.abs(want).max())
        else:
            assert np.array_equal(_np(frame), want)
        assert holes.dtype == torch.bool and np.array_equal(holes.numpy(), want_holes > 0)
        assert 0 < holes.sum() < holes.numel()


def test_splat_gradients_match_jax(splat_case):
    """Autograd of the port's scatter gives JAX's VJP: the gradients of
    ``softsplat_raw`` for ``x`` and ``flow``, and of the two-frame merge
    for ``x``, ``flow`` and ``metric``, each within 1e-6 of its max abs."""
    inputs, ct, _, (want_raw, want_two) = splat_case
    x, flow, metric = (_torch(a).requires_grad_(True) for a in inputs["float32"])
    (softsplat_raw(x, flow) * torch.from_numpy(ct)).sum().backward()
    got_raw = (x.grad.numpy(), flow.grad.numpy())
    x.grad = flow.grad = None
    t = torch.full((2, 1, 1, 1), 0.4)
    out, _ = fwarp_using_two_frames(x, flow, t, x.flip(0), -flow.flip(0), 1.0 - t, metric,
                                    metric.flip(0))
    (out * torch.from_numpy(ct)).sum().backward()
    got_two = (x.grad.numpy(), flow.grad.numpy(), metric.grad.numpy())
    for got, want in zip(got_raw + got_two, tuple(want_raw) + tuple(want_two)):
        assert np.abs(want).max() > 0 and _within(got, want, SPLAT_TOL * np.abs(want).max())


@pytest.mark.parametrize("mode, metric, match", [
    ("cubic", False, "unsupported mode"), ("sum", True, "takes no metric"),
    ("soft", False, "requires a metric"), ("avg-fooeps", False, "unsupported eps variant")])
def test_softsplat_refuses_what_jax_refuses(mode, metric, match):
    x, flow, m = (torch.zeros(1, 4, 4, c) for c in (2, 2, 1))
    with pytest.raises(ValueError, match=match):
        softsplat(x, flow, m if metric else None, mode)
    # JAX raises while tracing (the eps variant after tracing the splat).
    with pytest.raises(ValueError, match=match):
        jax.jit(lambda a, f, w: jax_softsplat.softsplat(a, f, w if metric else None, mode))(
            *(np.zeros(a.shape, np.float32) for a in (x, flow, m)))


# ---------------------------------------------------------------------------
# The transformer's helpers and the feature transformer.

@pytest.mark.parametrize("h, w, k", [(8, 8, 2), (4, 14, 2), (6, 6, 3)])
def test_window_helpers_and_shift_mask_match_jax(h, w, k):
    x = np.random.default_rng(2).normal(size=(2, h, w, 3)).astype(np.float32)
    split = transformer.split_windows(torch.from_numpy(x), k)
    assert np.array_equal(split.numpy(), np.asarray(jax_transformer.split_windows(x, k)))
    assert torch.equal(transformer.merge_windows(split, k), torch.from_numpy(x))
    mask = transformer.shifted_window_attn_mask(h, w, k)
    assert mask.dtype == np.float32 and mask.shape == (k * k, h * w // (k * k), h * w // (k * k))
    assert np.array_equal(mask, jax_transformer.shifted_window_attn_mask(h, w, k))
    assert set(np.unique(mask)) == {-100.0, 0.0}


def _feature_transformer():
    torch.manual_seed(3)
    ft = transformer.FeatureTransformer(2, 24)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in ft.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.05, tuple(p.shape)).astype(np.float32)))
    return ft


@pytest.fixture(scope="module")
def transformer_case():
    """Two-layer transformer parameters (the port's, plus noise), two 8x8
    feature maps, and JAX's transformer (2 x 2 windows and one window) and
    correlation in fp32 and bf16, compiled side by side."""
    ft = _feature_transformer()
    params = params_to_flax(dict(ft.named_parameters()), ft)
    rng = np.random.default_rng(4)
    f0, f1 = (rng.normal(size=(2, 8, 8, 24)).astype(np.float32) for _ in range(2))

    def jax_run(p, a, b, dtype):
        mod = jax_transformer.FeatureTransformer(2, 24, dtype=dtype)
        a, b = a.astype(dtype), b.astype(dtype)
        out = [mod.apply(p, a, b, num_splits=s) for s in (2, 1)]
        return out, jax_transformer.global_correlation_softmax(*out[0])

    calls = compile_side_by_side(
        *[(lambda p, a, b, d=d: jax_run(p, a, b, DTYPES[d][0]), (params, f0, f1))
          for d in DTYPES])
    ref = {d: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                     call(params, f0, f1)) for d, call in zip(DTYPES, calls)}
    return ft, f0, f1, ref


def test_feature_transformer_and_correlation_match_jax_in_fp32(transformer_case):
    """With and without splits, and the correlation's flows and dual-softmax
    certainty, each within ``BLOCK_TOL`` of its max abs; the flows in the
    features' dtype."""
    ft, f0, f1, ref = transformer_case
    (want2, want1), corr = ref["float32"]
    with torch.no_grad():
        got = [ft(torch.from_numpy(f0), torch.from_numpy(f1), num_splits=s) for s in (2, 1)]
        got_corr = transformer.global_correlation_softmax(*got[0])
    assert got_corr[0].dtype == torch.float32 and tuple(got_corr[2].shape) == (2, 64, 64)
    pairs = list(zip(got[0] + got[1] + got_corr, want2 + want1 + corr))
    for out, want in pairs:
        assert tuple(out.shape) == want.shape
        assert _within(_np(out), want, BLOCK_TOL * np.abs(want).max())
    # The two window layouts compute different functions.
    assert not _within(want2[0], want1[0], 1e-2)


def test_feature_transformer_and_correlation_in_bf16_within_half_of_jaxs_gap(transformer_case):
    """Each output (both layouts, both frames) and the correlation's flows
    in bf16: mean abs within half of JAX's own bf16-vs-fp32 gap."""
    _, f0, f1, ref = transformer_case
    ft16 = _feature_transformer().to(torch.bfloat16)
    with torch.no_grad():
        got = [ft16(_torch(f0, "bfloat16"), _torch(f1, "bfloat16"), num_splits=s) for s in (2, 1)]
        flows = transformer.global_correlation_softmax(*got[0])[:2]
    (outs16, corr16), (outs32, corr32) = ref["bfloat16"], ref["float32"]
    cases = [(got[s][i], outs16[s][i], outs32[s][i]) for s in (0, 1) for i in (0, 1)]
    cases += [(flows[i], corr16[i], corr32[i]) for i in (0, 1)]
    for out, want16, want32 in cases:
        assert out.dtype == torch.bfloat16
        gap = np.abs(want16 - want32).mean()
        assert gap > 0 and np.abs(_np(out) - want16).mean() <= BF16_GAP_SHARE * gap


# ---------------------------------------------------------------------------
# The whole model against JAX.

def _tiny_model() -> GMTrans:
    """The tiny GMTrans: the port's initialisation (seed 0) plus noise of
    ``NOISE``, then every LayerNorm scale times ``NORM_SCALE`` and the
    encoder's kernels times ``ENC_GAIN``."""
    torch.manual_seed(0)
    model = GMTrans(**KW)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.add_(torch.from_numpy(rng.normal(0, NOISE, tuple(p.shape)).astype(np.float32)))
            if name.endswith(".scale"):
                p.mul_(NORM_SCALE)
            elif name.startswith("enc") and name.endswith("conv.weight"):
                p.mul_(ENC_GAIN)
    return model


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny model's TrainState written by the port's checkpoint writer,
    JAX's parameters read from it, and a seeded batch: a smooth pair, its
    mean as the ground truth, pseudo-GT flows, two instants."""
    model = _tiny_model()
    ckpt = tmp_path_factory.mktemp("gmtrans") / "tiny.ckpt"
    write_flax_state(ckpt, state_to_flax(create_train_state(model, Config.from_yaml(YAML))))
    params = fser.msgpack_restore(ckpt.read_bytes())["params"]
    x0, x1 = smooth_pair(B, H, W, seed=12)
    rng = np.random.default_rng(13)
    batch = {"x0": x0, "x1": x1, "xt": 0.5 * (x0 + x1),
             "t": np.array([0.5, 0.3], np.float32).reshape(B, 1, 1, 1),
             "f0x": rng.normal(0, 2.0, (B, H, W, 2)).astype(np.float32),
             "f1x": rng.normal(0, 2.0, (B, H, W, 2)).astype(np.float32)}
    return ckpt, params, batch


@pytest.fixture(scope="module")
def jax_calls(tiny):
    """JAX's fp32 training loss (``train/step.py``'s GMTrans branch) with its
    gradient, the log, the frame and the intermediates in its aux, and its
    bf16 forward, compiled side by side."""
    _, params, batch = tiny
    model = JaxGMTrans(**KW)

    def loss_fn(p, b):
        pred, inter = model.apply(p, b["x0"], b["x1"], b["t"], train=True)
        total, log = jax_gmtrans_loss(pred, inter, b)
        return total, (log, pred, inter)

    x = [batch[k] for k in ("x0", "x1", "t")]
    return compile_side_by_side((jax.value_and_grad(loss_fn, has_aux=True), (params, batch)),
                                (JaxGMTrans(**KW, dtype=jnp.bfloat16).apply, (params, *x)))


@pytest.fixture(scope="module")
def jax_fp32(tiny, jax_calls):
    _, params, batch = tiny
    (_, aux), grads = jax_calls[0](params, batch)
    return jax.tree_util.tree_map(np.asarray, aux), grads


def _port(ckpt, dtype="float32") -> GMTrans:
    """The tiny model with the checkpoint's parameters, in ``dtype``."""
    model = GMTrans(**KW, compute_dtype=DTYPES[dtype][1])
    model.load_state_dict(params_from_flax(read_flax_msgpack(ckpt), model))
    return model.to(DTYPES[dtype][1]).eval()


def test_forward_and_intermediates_match_jax_in_fp32(tiny, jax_fp32):
    """The frame and JAX's intermediates; the staged ``encode``/``decode``
    (``multi_t_apply``) equal to the forward bit for bit."""
    ckpt, _, batch = tiny
    (_, ref_pred, ref_inter), _ = jax_fp32
    model = _port(ckpt)
    x = [torch.from_numpy(batch[k]) for k in ("x0", "x1", "t")]
    with torch.no_grad():
        pred, inter = model(*x, train=True)
        assert torch.equal(model(*x), pred)
        multi = multi_t_apply(model, x[0], x[1], [0.5, 0.3])
    assert torch.equal(multi[0, 0], pred[0]) and torch.equal(multi[1, 1], pred[1])
    assert set(inter) == set(ref_inter) == {"base", "pred_f01", "pred_f10"}
    for key in inter:
        assert inter[key].dtype == torch.float32
        assert tuple(inter[key].shape) == ref_inter[key].shape == (B, H, W, 3 if key == "base"
                                                                   else 2)
    for got, want in [(pred, ref_pred)] + [(inter[k], ref_inter[k]) for k in inter]:
        err = np.abs(got.numpy() - want)
        assert err.max() <= MAX_TOL and err.mean() <= MEAN_TOL, (err.max(), err.mean())
    # The flows move pixels, and the two instants give different frames.
    assert np.abs(ref_inter["pred_f01"]).max() > 1.0
    assert not torch.equal(multi[0, 0], multi[1, 0])


def test_forward_in_bf16_within_half_of_jaxs_own_gap(tiny, jax_calls, jax_fp32):
    ckpt, params, batch = tiny
    (_, ref32, _), _ = jax_fp32
    x = [batch[k] for k in ("x0", "x1", "t")]
    ref16 = np.asarray(jax_calls[1](params, *x))
    model = _port(ckpt, "bfloat16")
    assert model.dtype == torch.bfloat16 and model.alpha.dtype == torch.bfloat16
    with torch.no_grad():
        out = model(*map(torch.from_numpy, x)).numpy()
    gap = np.abs(ref16 - ref32).mean()
    err = np.abs(out - ref16).mean()
    print(f"GMTrans bf16: port vs JAX {err:.3e}, {err / gap:.3f} of JAX's bf16-vs-fp32 gap")
    assert out.dtype == np.float32 and out.shape == ref16.shape == (B, H, W, 3)
    assert gap > 0 and err <= BF16_GAP_SHARE * gap


def test_loss_terms_and_gradients_match_jax(tiny, jax_fp32):
    """``gmtrans_loss`` through ``make_loss_fn`` and every gradient,
    ``alpha``'s (through the splat metrics) included."""
    ckpt, _, batch = tiny
    (ref_log, _, _), ref_grads = jax_fp32
    cfg = Config.from_yaml(YAML, compute_dtype="float32")
    model = GMTrans(**KW)
    model.load_state_dict(params_from_flax(read_flax_msgpack(ckpt), model))
    total, log = make_loss_fn(model, cfg)({k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    assert set(log) == set(ref_log) == {"total_loss", "l1_loss", "census_loss", "flow_loss"}
    for key, value in log.items():
        want = float(ref_log[key])
        assert want > 0 and abs(value.item() - want) <= LOSS_TOL * want, key
    ref = params_from_flax(ref_grads, model)
    assert all(p.grad is not None for p in model.parameters())
    want_alpha = ref["alpha"].item()
    print(f"alpha gradient: port {model.alpha.grad.item():.6e}, JAX {want_alpha:.6e}")
    assert abs(want_alpha) > 1e-5
    assert abs(model.alpha.grad.item() - want_alpha) <= GRAD_TOL * abs(want_alpha)
    got = torch.cat([p.grad.flatten() for _, p in sorted(model.named_parameters())])
    want = torch.cat([ref[k].flatten() for k, _ in sorted(model.named_parameters())])
    err = ((got - want).norm() / want.norm()).item()
    print(f"GMTrans loss gradient: relative L2 error {err:.3e}")
    assert err <= GRAD_TOL


def test_flax_round_trip_is_exact(tiny):
    """Every leaf, the new ones included (the root ``alpha``, the
    transformer's bias-free Dense kernels and LayerNorms, the decoders'
    ``upconv``), read and written back bit for bit; a leaf of the wrong
    shape raises."""
    _, params, _ = tiny
    model = GMTrans(**KW)
    back = params_to_flax(params_from_flax(params, model), model)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert flat.keys() == ref.keys()
    assert all(np.array_equal(flat[k], np.asarray(ref[k])) for k in ref)
    names = {jax.tree_util.keystr(k) for k in ref}
    for leaf in ("['alpha']", "['transformer']['layer1']['cross_attn_ffn']['mlp2']['kernel']",
                 "['transformer']['layer0']['self_attn']['norm1']['scale']",
                 "['decoder3']['upconv']['kernel']", "['enc3b']['prelu']['alpha']"):
        assert f"['params']{leaf}" in names, leaf
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["params"]["alpha"] = bad["params"]["alpha"][0]
    with pytest.raises(ValueError, match="alpha"):
        params_from_flax(bad, model)


def test_full_width_model_from_the_yaml():
    """``configs/archive/GMTrans.yaml`` (``model_name: GMTransv1``) builds
    the port's GMTrans at full width with JAX's parameter tree: the same
    names and shapes as ``jax.eval_shape`` of the JAX model's ``init``,
    5,768,469 parameters, ``alpha`` 10 and the transformer's kernels
    xavier-uniform. ``GMTrans`` names the same model; ``DCNTransv2``
    raises, naming what it lacks."""
    cfg = Config.from_yaml(YAML)
    assert cfg.model_name == "GMTransv1"
    torch.manual_seed(0)
    model = create_model(cfg, torch.float32)
    assert isinstance(model, GMTrans) and model.dtype == torch.bfloat16
    assert isinstance(create_model(Config.from_yaml(YAML, model_name="GMTrans")), GMTrans)
    with pytest.raises(ValueError, match="DeformableConv2dWithFwarp"):
        create_model(Config.from_yaml(YAML, model_name="DCNTransv2"))
    x = np.zeros((1, 64, 64, 3), np.float32)
    jmodel = jax_create_model(JaxConfig.from_yaml(YAML))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), x, x, np.zeros((1, 1, 1, 1)))
    ref = {jax.tree_util.keystr(k): v.shape for k, v in jax.tree_util.tree_leaves_with_path(shapes)}
    ours = params_to_flax(dict(model.named_parameters()), model)
    assert ref == {jax.tree_util.keystr(k): v.shape
                   for k, v in jax.tree_util.tree_leaves_with_path(ours)}
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s in ref.values()) == 5_768_469
    assert model.alpha.shape == (1, 1, 1, 1) and model.alpha.item() == 10.0
    q = model.transformer.layer0.self_attn.q_proj.weight
    assert q.abs().max() <= (6 / 256) ** 0.5 and 0.8 <= q.std().item() / (2 / 256) ** 0.5 <= 1.25


# ---------------------------------------------------------------------------
# The entry points on configs/archive/GMTrans.yaml (full width, tiny crops).

TINY_SETS = ["data_name=Vimeo90KwFlow", "crop_h=32", "crop_w=32", "batch_size=2",
             "num_workers=1", "num_epochs=1", "compute_dtype=float32", "metric_summary_freq=1",
             "img_summary_freq=2"]


@pytest.fixture(scope="module")
def gmtrans_run(tmp_path_factory):
    """Two steps of ``python -m videoframeinterpolation_tpu_torch.train`` on
    the YAML at 32x32 crops, validated after its epoch, on a tree with the
    forward flows the YAML's ``flow_dir`` names (``distill_bwd: false``).
    The YAML names ``data_name: Vimeo90K``, whose batches carry no flows:
    the run sets ``Vimeo90KwFlow``."""
    base = tmp_path_factory.mktemp("gmtrans_run")
    fixtures.write_vimeo90k_train(base, 4, (40, 48), [(32, 48)] * 2, seed=17,
                                  flow_dir="gmflow_scale2_refine6")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_logger, "_try_tensorboard", lambda log_dir: None)
        torch.set_num_threads(1)
        trainer = run_in(base, train_cli.main, ["--exp_name", "gmt", "--config", str(YAML),
                                                "--device", "cpu",
                                                *[a for kv in TINY_SETS for a in ("--set", kv)]])
    return base, trainer


def test_train_cli_trains_the_yaml(gmtrans_run):
    base, trainer = gmtrans_run
    # The YAML's own Vimeo90K gives batches without flows: the loss says so.
    cfg = Config.from_yaml(YAML, root=str(base / "datasets" / "vimeo_triplet"), crop_h=32,
                           crop_w=32, compute_dtype="float32")
    item = {k: torch.from_numpy(v)[None] for k, v in build_dataset(cfg)[0].items()}
    assert "f0x" not in item
    with pytest.raises(ValueError, match="data_name Vimeo90KwFlow"):
        make_loss_fn(trainer.state.model, cfg)(item)
    assert isinstance(trainer.state.model, GMTrans) and trainer.state.step == 2
    run = base / "exps" / "gmt"
    cfg = Config.from_yaml(run / "config.yaml")
    assert (cfg.model_name, cfg.data_name, cfg.flow_dir, cfg.distill_bwd, cfg.grad_clip) == (
        "GMTransv1", "Vimeo90KwFlow", "gmflow_scale2_refine6", False, 1.0)
    records = [r for r in map(json.loads, (run / "metrics.jsonl").read_text().splitlines())
               if "train/total_loss" in r]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[f"train/{k}"]) and r[f"train/{k}"] > 0 for r in records
               for k in ("l1_loss", "census_loss", "flow_loss"))
    assert (run / "checkpoints" / "best_vimeo90k.ckpt").is_file()
    assert sorted(p.name for p in (run / "images").iterdir()) == ["flow_0000002.png",
                                                                  "pred_0000002.png"]


def test_evaluate_and_interpolate_serve_the_run(gmtrans_run, tmp_path):
    """``evaluate --exp_name`` gives the trainer's validation score;
    ``interpolate`` serves the run's checkpoint in pair mode and in both
    sequence modes (direct: one encoder run per pair, the same frames as
    pair mode at those instants), and refuses ``--tile``."""
    base, _ = gmtrans_run
    scores = run_in(base, evaluate.main, ["--exp_name", "gmt", "--device", "cpu"])
    val = [r for r in map(json.loads, (base / "exps" / "gmt" / "metrics.jsonl").read_text()
                          .splitlines()) if "val/vimeo90k/val/vimeo90k_psnr" in r]
    assert abs(scores["val/vimeo90k_psnr"] - val[0]["val/vimeo90k/val/vimeo90k_psnr"]) <= 1e-4
    config = str(base / "exps" / "gmt" / "config.yaml")
    ckpt = str(base / "exps" / "gmt" / "checkpoints" / "best_vimeo90k.ckpt")
    seq = base / "datasets" / "vimeo_triplet" / "sequences" / "00001" / "0001"
    pair = ["--frame0", str(seq / "im1.png"), "--frame1", str(seq / "im3.png")]
    interpolate.main(["--config", config, "--ckpt", ckpt, *pair, "--out",
                      str(tmp_path / "mid.png"), "--t", "0.25", "--device", "cpu"])
    model = interpolate.load_model(Config.from_yaml(config), ckpt, device="cpu")
    frames = [interpolate.read_frame(seq / f) for f in ("im1.png", "im2.png", "im3.png")]
    assert np.array_equal(interpolate.read_frame(tmp_path / "mid.png"),
                          interpolate.interp_pair(model, frames[0], frames[2], t=0.25))

    (tmp_path / "in").mkdir()
    for i, f in enumerate(frames):
        interpolate.write_frame(tmp_path / "in" / f"{i}.png", f)
    for mode in ("recursive", "direct"):
        interpolate.main(["--config", config, "--ckpt", ckpt, "--in_dir", str(tmp_path / "in"),
                          "--out_dir", str(tmp_path / mode), "--factor", "4", "--mode", mode,
                          "--device", "cpu"])
        written = sorted((tmp_path / mode).iterdir())
        assert [p.name for p in written] == [f"{i:06d}.png" for i in range(9)]
    direct = sorted((tmp_path / "direct").iterdir())
    for i, t in ((1, 0.25), (2, 0.5), (3, 0.75)):
        assert np.array_equal(interpolate.read_frame(direct[i]),
                              interpolate.interp_pair(model, frames[0], frames[1], t=t))

    with pytest.raises(SystemExit, match="GMTrans returns none"):
        interpolate.main(["--config", config, "--ckpt", ckpt, *pair, "--out",
                          str(tmp_path / "t.png"), "--tile", "16", "--device", "cpu"])
    with pytest.raises(SystemExit, match="GMTrans returns none"):
        run_in(base, evaluate.main, ["--exp_name", "gmt", "--tile", "16", "--device", "cpu"])


class _Event:
    """A stand-in for one of the profiler's raw events (times in ms)."""

    def __init__(self, name, start, end, device="CPU", corr=0, linked=0, thread=1,
                 annotation=False):
        self._v = dict(name=name, device_type=getattr(torch.autograd.DeviceType, device),
                       correlation_id=corr, linked_correlation_id=linked,
                       start_thread_id=thread, start_ns=int(start * 1e6), end_ns=int(end * 1e6),
                       duration_ns=int((end - start) * 1e6), is_user_annotation=annotation)

    def __getattr__(self, key):
        return lambda: self._v[key]


def test_profile_serve_gives_each_range_the_device_time_its_ops_launched():
    """``tools/profile_serve.py`` reads the ranges it opens (the splat
    merges among them) from the profiler's raw events: a device operation
    belongs to a range when the host op that launched it (its correlation
    id) ran inside one of the range's calls on the same thread."""
    from types import SimpleNamespace

    from videoframeinterpolation_tpu_torch.tools import profile_serve

    splat = profile_serve.RANGES["splat"]
    events = [_Event(splat, 0, 10), _Event("aten::index_put_", 1, 2, corr=7),
              _Event("aten::mul", 12, 13, corr=8), _Event(splat, 20, 30),
              _Event("aten::add", 21, 22, corr=9), _Event("aten::mul", 25, 26, corr=10, thread=2),
              _Event("kernel_a", 3, 5, device="CUDA", linked=7),
              _Event("kernel_b", 14, 15, device="CUDA", linked=8),
              _Event("kernel_a", 23, 26, device="CUDA", linked=9),
              _Event("kernel_c", 27, 28, device="CUDA", linked=10),
              _Event(splat, 3, 26, device="CUDA", annotation=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    got = profile_serve.range_device_ms(prof, [splat, "swin_decoder"])
    assert got == {splat: (2, pytest.approx(5.0)), "swin_decoder": (0, 0.0)}
