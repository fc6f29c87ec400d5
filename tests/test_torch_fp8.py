"""The port's fp8 training path on the CPU against the JAX package: the
quantizers and scaling helpers bit for bit, the fp8 GEMM's plain version
(kernel row 12) and the differentiable ``fp8_matmul`` against JAX's Pallas
kernel in interpret mode and its custom VJP, ``Fp8Linear`` and the
``fp8_hybrid`` policy, an fp8_hybrid JAX model carried across by
``load_jax_params``, three optimizer steps of a tiny SigLIP under the
policy, and the ``train --precision fp8_hybrid`` command."""

import json
import math
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import configs as jax_configs
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.nn.transformer import Attention as JaxAttention
from jimm_tpu.ops import fp8_matmul as jfp8
from jimm_tpu.quant.policy import apply_precision_policy as jax_policy
from jimm_tpu.train import trainer as jax_trainer
from jimm_tpu_torch import configs
from jimm_tpu_torch.models.siglip import SigLIP, _port_entries, load_jax_params
from jimm_tpu_torch.nn.transformer import Attention
from jimm_tpu_torch.ops import fp8_matmul as fp8
from jimm_tpu_torch.quant.policy import (DEFAULT_AMAX_HISTORY, Fp8Linear,
                                         apply_precision_policy, fp8_linear)
from jimm_tpu_torch.train import trainer
from test_torch_siglip import tiny_config
from test_torch_train import _port_arrays

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
#: (M, K, N) off the tile grid (tests/test_fp8_ops.py ODD_MATMUL_SHAPES)
ODD_MATMUL_SHAPES = [(1, 7, 5), (5, 100, 33), (33, 64, 128),
                     (257, 769, 129), (16, 768, 768)]
FORMATS = [(jnp.float8_e4m3fn, fp8.E4M3), (jnp.float8_e5m2, fp8.E5M2)]
LR = 1e-3
STEPS = 3


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _tol(*dims: int) -> dict:
    """tests/test_fp8_ops.py's quantization-aware tolerance: the kernel's
    only liberty is the f32 summation order."""
    return dict(rtol=1e-5, atol=1e-3 * max(1, max(dims) // 64))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.uint8).numpy()


def _fp8_values(rng: np.random.Generator, dtype) -> np.ndarray:
    """Values across the format's whole range: saturating ones past its
    max, subnormals, exact ties between two neighbours, zeros, and normal
    samples over many scales."""
    fmax = float(jnp.finfo(dtype).max)
    grid = np.asarray(jnp.asarray(
        np.arange(256, dtype=np.uint8)).view(dtype).astype(jnp.float32))
    grid = np.unique(grid[np.isfinite(grid)])
    ties = (grid[1:] + grid[:-1]) / 2
    scales = 10.0 ** rng.integers(-8, 6, 4000)
    return np.concatenate([
        grid, ties, -ties, [0.0, -0.0, 2 * fmax, -3 * fmax, 1e30],
        grid[1:40] * 0.75, rng.standard_normal(4000) * scales,
    ]).astype(np.float32)


# -- quantizers and scales -----------------------------------------------------

@pytest.mark.parametrize("jdtype,tdtype", FORMATS, ids=["e4m3", "e5m2"])
@pytest.mark.parametrize("scale", [1.0, 0.37, 3e-4])
def test_quantize_tensor_matches_jax_bit_for_bit(jdtype, tdtype, scale):
    x = _fp8_values(np.random.default_rng(0), jdtype)
    s = np.float32(scale)
    want = np.asarray(jfp8.quantize_tensor(jnp.asarray(x), jnp.asarray(s),
                                           jdtype)).view(np.uint8)
    got = fp8.quantize_tensor(_t(x), torch.tensor(s), tdtype)
    assert got.dtype == tdtype
    np.testing.assert_array_equal(_bits(got), want)
    # saturation, never inf
    assert torch.isfinite(got.float()).all()
    assert got.float().abs().max().item() == float(jnp.finfo(jdtype).max)


@pytest.mark.parametrize("jdtype,tdtype", FORMATS, ids=["e4m3", "e5m2"])
def test_scales_match_jax(jdtype, tdtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((33, 65)).astype(np.float32) * 7
    for arr in (x, np.zeros((4, 4), np.float32)):
        want = jfp8.dynamic_scale(jnp.asarray(arr), jdtype)
        got = fp8.dynamic_scale(_t(arr), tdtype)
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.item() == float(want)
        assert fp8.tensor_amax(_t(arr)).item() == float(
            jfp8.tensor_amax(jnp.asarray(arr)))
    assert fp8.dynamic_scale(torch.zeros(3, 3), tdtype).item() == 1.0
    hist = np.asarray([1.0, 448.0, 2.0, 0.5], np.float32)
    assert fp8.delayed_scale(_t(hist), tdtype).item() == float(
        jfp8.delayed_scale(jnp.asarray(hist), jdtype))
    assert fp8.delayed_scale(torch.zeros(16), tdtype).item() == 1.0
    rolled = fp8.update_amax_history(_t(hist), torch.tensor(7.0))
    np.testing.assert_array_equal(rolled.numpy(), np.asarray(
        jfp8.update_amax_history(jnp.asarray(hist), jnp.asarray(7.0))))
    np.testing.assert_array_equal(rolled.numpy(), [448.0, 2.0, 0.5, 7.0])


# -- the GEMM and the differentiable matmul ------------------------------------

@pytest.mark.parametrize("m,k,n", ODD_MATMUL_SHAPES)
@pytest.mark.parametrize("a_fmt", ["e4m3", "e5m2"])
def test_fp8_gemm_plain_matches_jax(m, k, n, a_fmt):
    """Kernel row 12's plain version against JAX's Pallas GEMM (interpret
    mode) on the same fp8 operands, e4m3 x e4m3 (forward) and e5m2 x e4m3
    (the backward's), with a bias and a scale."""
    rng = np.random.default_rng(m + k + n)
    jdt, tdt = FORMATS[0] if a_fmt == "e4m3" else FORMATS[1]
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    sa, sb = (jfp8.dynamic_scale(jnp.asarray(a), jdt),
              jfp8.dynamic_scale(jnp.asarray(b), jnp.float8_e4m3fn))
    a_q = jfp8.quantize_tensor(jnp.asarray(a), sa, jdt)
    b_q = jfp8.quantize_tensor(jnp.asarray(b), sb, jnp.float8_e4m3fn)
    want = jfp8._fp8_gemm(a_q, b_q, sa * sb, jnp.asarray(bias), None, None)
    ta = _t(np.asarray(a_q).view(np.uint8)).view(tdt)
    tb = _t(np.asarray(b_q).view(np.uint8).T).view(fp8.E4M3)  # (N, K)
    before = fp8.launches
    got = fp8.fp8_gemm(ta, tb, torch.tensor(float(sa * sb)), _t(bias))
    assert fp8.launches == before  # the plain version on the CPU
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(k))


@pytest.mark.parametrize("m,k,n", ODD_MATMUL_SHAPES)
def test_fp8_matmul_forward_and_grads_match_jax(m, k, n):
    """``Fp8MatmulFn`` against the JAX custom VJP: forward, dx, dw and dbias
    from the same inputs, scales and cotangent (the port's w is (N, K))."""
    rng = np.random.default_rng(7 * m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    xs = jfp8.dynamic_scale(jnp.asarray(x), jnp.float8_e4m3fn)
    ws = jfp8.dynamic_scale(jnp.asarray(w), jnp.float8_e4m3fn)

    def f(x, w, b):
        return jfp8.fp8_matmul(x, w, b, x_scale=xs, w_scale=ws)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    jdx, jdw, jdb = vjp(jnp.asarray(dy))
    tx, tb = _t(x).requires_grad_(), _t(bias).requires_grad_()
    tw = _t(w.T).requires_grad_()
    got = fp8.fp8_matmul(tx, tw, tb, x_scale=torch.tensor(float(xs)),
                         w_scale=torch.tensor(float(ws)))
    got.backward(_t(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), **_tol(k))
    tol = _tol(k, m, n)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **tol)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jdw), **tol)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), rtol=1e-5,
                               atol=1e-5 * max(1, m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cotangents_land_in_the_primal_dtypes(dtype):
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((6, 16)).astype(np.float32)).to(dtype)
    w = _t(rng.standard_normal((8, 16)).astype(np.float32)).to(dtype)
    b = torch.zeros(8, dtype=dtype)
    for t in (x, w, b):
        t.requires_grad_()
    y = fp8.fp8_matmul(x, w, b)
    assert y.dtype == torch.float32  # f32 out, as in JAX
    y.sum().backward()
    assert x.grad.dtype == w.grad.dtype == b.grad.dtype == dtype


def test_scales_get_no_gradient():
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((4, 8)).astype(np.float32)).requires_grad_()
    w = _t(rng.standard_normal((5, 8)).astype(np.float32)).requires_grad_()
    xs = torch.tensor(0.01, requires_grad=True)
    ws = torch.tensor(0.02, requires_grad=True)
    fp8.fp8_matmul(x, w, x_scale=xs, w_scale=ws).sum().backward()
    assert xs.grad is None and ws.grad is None
    assert x.grad is not None and w.grad is not None


def test_fp8_gemm_refuses_other_devices_and_formats():
    a = torch.zeros(4, 8, dtype=fp8.E4M3, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fp8.fp8_gemm(a, a, torch.ones((), device="meta"))
    with pytest.raises(ValueError, match="float8"):
        fp8.fp8_gemm(torch.zeros(4, 8), torch.zeros(4, 8), torch.ones(()))
    with pytest.raises(ValueError, match="do not agree"):
        fp8.fp8_gemm(torch.zeros(4, 8, dtype=fp8.E4M3),
                     torch.zeros(4, 7, dtype=fp8.E4M3), torch.ones(()))


# -- Fp8Linear and the policy --------------------------------------------------

def test_fp8_linear_shares_its_parameters():
    lin = torch.nn.Linear(16, 8)
    wrapped = fp8_linear(lin)
    assert wrapped.weight is lin.weight and wrapped.bias is lin.bias
    assert [n for n, _ in wrapped.named_parameters()] == ["weight", "bias"]
    assert dict(wrapped.named_buffers()).keys() == {"x_amax", "w_amax"}
    assert wrapped.x_amax.shape == (DEFAULT_AMAX_HISTORY,)
    assert wrapped.x_amax.dtype == torch.float32
    no_bias = fp8_linear(torch.nn.Linear(16, 8, bias=False))
    assert no_bias.bias is None
    assert no_bias(torch.ones(2, 16)).shape == (2, 8)


@pytest.mark.parametrize("train", [True, False])
def test_histories_roll_in_train_and_eval(train):
    """The scales come from the histories before this call's roll; the
    roll appends this call's amax of the input and the weight."""
    rng = np.random.default_rng(4)
    lin = fp8_linear(torch.nn.Linear(16, 8))
    lin.train(train)
    xs = [_t(rng.standard_normal((3, 5, 16)).astype(np.float32)) * (i + 1)
          for i in range(3)]
    for i, x in enumerate(xs):
        want_scale = fp8.delayed_scale(lin.x_amax.clone(), fp8.E4M3)
        want = fp8.fp8_gemm_plain(
            fp8.quantize_tensor(x.reshape(-1, 16), want_scale, fp8.E4M3),
            fp8.quantize_tensor(lin.weight.detach(), fp8.delayed_scale(
                lin.w_amax.clone(), fp8.E4M3), fp8.E4M3),
            want_scale * fp8.delayed_scale(lin.w_amax, fp8.E4M3),
            lin.bias.detach())
        y = lin(x)
        assert y.shape == (3, 5, 8) and y.dtype == lin.weight.dtype
        torch.testing.assert_close(y.detach().reshape(-1, 8), want,
                                   atol=0, rtol=0)
        assert lin.x_amax[-1].item() == x.abs().max().item()
        assert lin.w_amax[-1].item() == lin.weight.abs().max().item()
        assert (lin.x_amax[:-(i + 1)] == 0).all()
    assert lin.x_amax.grad_fn is None and not lin.x_amax.requires_grad


def test_histories_stay_outside_the_optimizer():
    model = SigLIP(tiny_config(configs), device="cpu")
    apply_precision_policy(model, "fp8_hybrid")
    opt = trainer.make_optimizer(model, trainer.OptimizerConfig())
    in_opt = {id(p) for p in opt.params}
    buffers = [b for n, b in model.named_buffers() if n.endswith("_amax")]
    assert len(buffers) == 2 * 31
    assert not any(id(b) in in_opt for b in buffers)
    assert all(not n.endswith("_amax") for n, _ in model.named_parameters())
    assert len(opt.params) == len(list(model.parameters()))


def test_policy_counts_match_jax():
    """The port counts each layer's Linear (2 + 2 blocks x 6, the MAP head's
    6, text_projection), the JAX package a stacked role once: the same
    Linears, so the port's count is JAX's weighted by each role's depth."""
    model = SigLIP(tiny_config(configs), device="cpu")
    assert apply_precision_policy(model, "fp8_hybrid") == 31
    jmodel = JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0))
    assert jax_policy(jmodel, "fp8_hybrid") == 19
    jax_layers = sum(
        int(np.prod(np.shape(v[...])[:-1]))
        for path, v in nnx.to_flat_state(nnx.state(jmodel))
        if str(path[-1]) == "x_amax")
    assert jax_layers == 31
    assert isinstance(model.text_projection, Fp8Linear)
    assert isinstance(model.vision.head.attn.q, Fp8Linear)


def test_fused_qkv_projections_stay_linear():
    attn = Attention(64, 2, fused_qkv=True)
    assert apply_precision_policy(attn, "fp8_hybrid") == 1
    assert isinstance(attn.out, Fp8Linear)
    assert all(type(getattr(attn, p)) is torch.nn.Linear
               for p in ("q", "k", "v"))
    jattn = JaxAttention(64, 2, nnx.Rngs(0), fused_qkv=True)
    assert jax_policy(jattn, "fp8_hybrid") == 1


# -- the model ----------------------------------------------------------------

def jax_state(model) -> dict[str, np.ndarray]:
    """The JAX model's parameters and amax histories by dotted path."""
    return {".".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model))
            if isinstance(v, nnx.Param) or str(path[-1]).endswith("_amax")}


def _port_model(state: dict[str, np.ndarray]) -> SigLIP:
    model = SigLIP(tiny_config(configs), device="cpu")
    apply_precision_policy(model, "fp8_hybrid")
    load_jax_params(model, state)
    return model


def test_load_jax_params_carries_the_histories():
    jmodel = JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0))
    jax_policy(jmodel, "fp8_hybrid")
    rng = np.random.default_rng(5)
    # warm histories: distinct values in every slot of every layer
    state = {k: (rng.random(v.shape).astype(np.float32)
                 if k.endswith("_amax") else v)
             for k, v in jax_state(jmodel).items()}
    stacked = state["vision.encoder.blocks.mlp.fc1.x_amax"]
    assert stacked.shape == (2, DEFAULT_AMAX_HISTORY)
    model = _port_model(state)
    own = dict(model.named_buffers())
    np.testing.assert_array_equal(
        own["vision.encoder.blocks.1.mlp.fc1.x_amax"].numpy(), stacked[1])
    np.testing.assert_array_equal(own["text_projection.w_amax"].numpy(),
                                  state["text_projection.w_amax"])
    weights = _port_arrays({k: v for k, v in state.items()
                            if k.endswith("kernel")})
    np.testing.assert_array_equal(
        dict(model.named_parameters())["text.encoder.blocks.0.attn.q.weight"]
        .detach().numpy(), weights["text.encoder.blocks.0.attn.q.weight"])
    # strict over the histories: one missing, or one the model lacks, raises
    with pytest.raises(KeyError, match="x_amax"):
        _port_model({k: v for k, v in state.items()
                     if k != "vision.head.mlp.fc2.x_amax"})
    plain = SigLIP(tiny_config(configs), device="cpu")
    with pytest.raises(KeyError, match="no port counterpart"):
        load_jax_params(plain, state)


@pytest.fixture(scope="module")
def fp8_run():
    """Both packages under fp8_hybrid from the same weights and one fixed
    batch: the first step's gradients (one forward and backward, which rolls
    every history once), then three AdamW steps (warmup 1, cosine to step 3,
    weight decay 0.5, clipping at 1), and the JAX state after them."""
    jmodel = JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0))
    jax_policy(jmodel, "fp8_hybrid")
    state0 = jax_state(jmodel)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 64, 64, 3), np.float32)
    text = rng.integers(0, 100, (4, 8)).astype(np.int32)
    opt_kw = dict(learning_rate=LR, weight_decay=0.5, warmup_steps=1,
                  total_steps=STEPS)
    ji, jt = jnp.asarray(images), jnp.asarray(text)

    def jloss(m, a, b):
        return jax_trainer.contrastive_loss_fn(m, a, b, kind="siglip")

    jgrads = nnx.jit(nnx.grad(jloss))(jmodel, ji, jt)
    jgrads = {".".join(str(p) for p in path): np.asarray(v[...])
              for path, v in nnx.to_flat_state(jgrads)}
    jhist1 = _port_arrays({k: v for k, v in jax_state(jmodel).items()
                           if k.endswith("_amax")})
    jopt = jax_trainer.make_optimizer(jmodel, jax_trainer.OptimizerConfig(
        **opt_kw))
    jstep = jax_trainer.make_contrastive_train_step("siglip")
    jlosses = [float(jstep(jmodel, jopt, ji, jt)["loss"])
               for _ in range(STEPS)]
    state3 = jax_state(jmodel)
    jloss3 = float(nnx.jit(jloss)(jmodel, ji, jt))

    tmodel = _port_model(state0)
    ti, tt = _t(images), _t(text).long()
    trainer.contrastive_loss_fn(tmodel, ti, tt, kind="siglip").backward()
    tgrads = {n: p.grad.clone() for n, p in tmodel.named_parameters()}
    thist1 = {n: b.clone() for n, b in tmodel.named_buffers()}
    topt = trainer.make_optimizer(tmodel, trainer.OptimizerConfig(**opt_kw))
    tstep = trainer.make_contrastive_train_step("siglip")
    tlosses = [tstep(tmodel, topt, ti, tt)["loss"].item()
               for _ in range(STEPS)]
    # the JAX model after the steps, carried across, one more loss
    tloss3 = trainer.contrastive_loss_fn(_port_model(state3), ti, tt,
                                         kind="siglip").item()
    return dict(jgrads=_port_arrays(jgrads), tgrads=tgrads, jhist1=jhist1,
                thist1=thist1, jlosses=jlosses, tlosses=tlosses,
                state3=_port_arrays(state3), tmodel=tmodel, jloss3=jloss3,
                tloss3=tloss3)


def test_fp8_first_step_grads_match_jax(fp8_run):
    """From the same weights and cold histories every quantized value is
    the same in both packages (the quantizers are bit-identical and their
    inputs agree to f32 rounding), so each parameter's gradient must agree
    to 1e-4 of its largest value; a gradient that is zero in exact
    arithmetic (the k-projection biases) is held to 1e-4 of 1e-3 of the
    model's largest, as chip_smoke.py holds them. Measured: 3e-6."""
    jg, tg = fp8_run["jgrads"], fp8_run["tgrads"]
    assert set(tg) == set(jg)
    floor = 1e-3 * max(np.abs(g).max() for g in jg.values())
    for name, got in tg.items():
        peak = max(np.abs(jg[name]).max(), floor)
        err = np.abs(got.numpy() - jg[name]).max()
        assert err <= 1e-4 * peak, (name, err / peak)


def test_fp8_histories_after_one_pass_match_jax(fp8_run):
    """After one forward every history holds one observation, the same
    amax in both packages up to f32 rounding, in the same (last) slot."""
    jh, th = fp8_run["jhist1"], fp8_run["thist1"]
    assert set(th) == set(jh) and len(th) == 62
    for name, got in th.items():
        got = got.numpy()
        assert (got[:-1] == 0).all() and got[-1] > 0, name
        np.testing.assert_allclose(got, jh[name], rtol=1e-5, err_msg=name)


def test_fp8_same_state_same_loss(fp8_run):
    """The JAX model after three steps (weights and full histories) carried
    across gives the JAX loss to f32 rounding: measured 7e-7."""
    np.testing.assert_allclose(fp8_run["tloss3"], fp8_run["jloss3"],
                               rtol=1e-5)


def test_fp8_three_steps_match_jax(fp8_run):
    """Three steps run free in each package. Quantization is discontinuous:
    Adam turns a gradient that is zero in exact arithmetic (the k-projection
    biases) into a move of up to the learning rate of either sign, so from
    the second update on the packages quantize slightly different tensors,
    and one e4m3 value that lands on the other side of a rounding boundary
    moves by 12.5% (an e5m2 gradient by 25%). Measured here: losses within
    1.5e-3, histories within 8e-3 of their values, weights within 0.7 lr.
    The bounds a flip passes: losses within 2%, every history slot within
    5% (and zero exactly where JAX's is), every weight within 2 lr a step
    of JAX's. A history not rolled, rolled the wrong way or scaled from the
    wrong slot, or a wrong scale or transposition, breaks the tests above."""
    r = fp8_run
    np.testing.assert_allclose(r["tlosses"][:2], r["jlosses"][:2], rtol=1e-5)
    np.testing.assert_allclose(r["tlosses"], r["jlosses"], rtol=2e-2)
    assert r["tlosses"][-1] < r["tlosses"][0]
    state = r["state3"]
    for name, buf in r["tmodel"].named_buffers():
        got, want = buf.numpy(), state[name]
        assert ((got == 0) == (want == 0)).all(), name
        np.testing.assert_allclose(got, want, rtol=5e-2, err_msg=name)
    for name, p in r["tmodel"].named_parameters():
        err = np.abs(p.detach().numpy() - state[name]).max()
        assert err <= 2 * LR * STEPS, (name, err)


# -- the train command --------------------------------------------------------

def test_train_cli_fp8_hybrid_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "jimm_tpu_torch", "train", "--tiny",
         "--device", "cpu", "--steps", "2", "--batch-size", "4",
         "--log-every", "1", "--precision", "fp8_hybrid", "--ln-impl",
         "fused"], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    assert [r["step"] for r in lines if "step" in r] == [0, 1]
    assert all(math.isfinite(r["loss"]) for r in lines if "step" in r)
    summary = lines[-1]
    assert summary["status"] == "trained" and summary["device"] == "cpu"
    # 4 + 4 blocks x 6 Linears, the MAP head's 6 and text_projection
    assert summary["precision"] == "fp8_hybrid"
    assert summary["precision_modules"] == 55
    assert fp8.launches == 0


#: the K ranges of the train step's GEMMs and of odd shapes
_K_RANGES = {
    (32768, 3072, 768): 1,     # fc1 forward: 6144 tiles
    (32768, 768, 768): 1,      # q/k/v/out forward
    (8192, 768, 768): 1,       # text forward: 384 tiles, K too short
    (128, 768, 768): 1,        # probe forward: 6 tiles, K too short
    (3072, 768, 32768): 4,     # fc1 dw: 144 tiles, four waves
    (768, 768, 32768): 15,     # q/k/v/out dw: 36 tiles, a last range of 512
    (768, 768, 8192): 13,      # text dw
    (1, 5, 7): 1, (257, 129, 769): 1}


@pytest.mark.parametrize("m,n,k", [(32768, 3072, 768), (3072, 768, 32768),
                                   (768, 768, 32768), (128, 768, 768),
                                   (257, 129, 769), (1, 5, 7),
                                   (32768, 768, 768), (8192, 768, 768),
                                   (768, 768, 8192)])
def test_k_ranges_cover_k_and_fill_the_card(m, n, k):
    """The kernel's split of K: ranges of whole multiples of 128 that
    cover K; one range when the output has four tiles for each of 132 SMs,
    else enough ranges for four CTAs an SM where K allows ranges of at
    least 512; at the train step's shapes, the counts of ``_K_RANGES``."""
    k_split = fp8.k_range(m, n, k, 132)
    ranges = -(-k // k_split)
    assert ranges == _K_RANGES[(m, n, k)]
    assert k_split % 128 == 0
    assert (ranges - 1) * k_split < k <= ranges * k_split
    tiles = -(-m // 128) * -(-n // 128)
    wanted = 1 if tiles >= 4 * 132 else max(1, min(-(-4 * 132 // tiles),
                                                   k // 512))
    # the shortest ranges of whole 128s that make at most ``wanted``
    assert ranges <= wanted
    assert k_split == 128 or -(-k // (k_split - 128)) > wanted
