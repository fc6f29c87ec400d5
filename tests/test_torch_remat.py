"""Remat, the saveable attention impl and dropout: the port against the JAX
package on the CPU, from seeded numpy inputs and JAX weights carried
across by ``load_jax_params``, at depth 2 and width 64 (flash attention
and the fused LayerNorm: their plain versions here, Pallas interpret mode
on the JAX side).

Tolerances: against JAX (f32), losses rtol 1e-5 and each gradient rtol
1e-4 with atol 1e-5 of its largest magnitude (at least 1e-5; the
first-step gradient tolerance of ``test_torch_train.py``, scaled: the
ViT's random head makes gradients of size ~25); the port's remat against
its own no-remat run bit for bit (the recompute runs the same functions on
the same inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from torch.utils.checkpoint import CheckpointPolicy

from jimm_tpu import configs as jax_configs
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.models.vit import VisionTransformer as JaxViT
from jimm_tpu.nn.transformer import Transformer as JaxTransformer
from jimm_tpu.ops.attention import saveable_attention as jax_saveable
from jimm_tpu_torch import configs
from jimm_tpu_torch.models.siglip import SigLIP
from jimm_tpu_torch.models.common import _port_entries, load_jax_params
from jimm_tpu_torch.models.vit import VisionTransformer
from jimm_tpu_torch.nn import remat
from jimm_tpu_torch.nn.remat import Dropout
from jimm_tpu_torch.nn.transformer import Block, Transformer
from jimm_tpu_torch.ops import attention
from jimm_tpu_torch.ops import flash_attention as fa
from jimm_tpu_torch.ops import flash_attention_int8 as fa8
from jimm_tpu_torch.ops import layer_norm as ln
from jimm_tpu_torch.quant.policy import apply_precision_policy
from jimm_tpu_torch.train import trainer
from test_torch_siglip import jax_params, tiny_config

#: every --remat spec the JAX CLI takes ("none" is remat off)
SPECS = ["none", "full", "dots", "dots+ln", "dots+act", "dots+ln+act",
         "dots+attn", "dots+ln+act+attn"]
POLICIES = SPECS[1:]
MALFORMED = ["dot", "dots+ln+mlp", "ln", "dots+", "full+ln"]


def assert_grad_close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4, err_msg=what)


def _runtime(spec: str) -> dict:
    """The runtime fields of a spec: "+attn" needs the saveable impl."""
    impl = "saveable" if spec.endswith("attn") else "flash"
    return dict(attn_impl=impl, **configs.parse_remat(spec))


def vit_config(cfg_mod, **runtime):
    cfg = cfg_mod.ViTConfig(
        vision=cfg_mod.VisionConfig(image_size=32, patch_size=16, width=64,
                                    depth=2, num_heads=2, mlp_dim=128,
                                    ln_eps=1e-12),
        num_classes=5)
    runtime = {"attn_impl": "flash", **runtime}
    return cfg_mod.with_runtime(cfg, ln_impl="fused", **runtime)


def jax_vit(**runtime) -> JaxViT:
    """The JAX tiny ViT from nnx.Rngs(0) with a seeded random head and
    ln_post bias (the zero-initialised head would zero every gradient
    below it)."""
    model = JaxViT(vit_config(jax_configs, **runtime), rngs=nnx.Rngs(0))
    rng = np.random.default_rng(1)
    model.classifier.kernel[...] = jnp.asarray(
        rng.standard_normal((64, 5), np.float32) * 0.5)
    model.vision.ln_post.bias[...] = jnp.asarray(
        rng.standard_normal(64, np.float32))
    return model


def port_vit(params, **runtime) -> VisionTransformer:
    model = VisionTransformer(vit_config(configs, **runtime), device="cpu")
    load_jax_params(model, params)
    return model


@pytest.fixture(scope="module")
def vit_batch():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 32, 32, 3), np.float32)
    labels = np.array([0, 1, 2, 4], np.int32)
    return images, labels, jax_params(jax_vit())


def _port_grads(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _jax_grads(grads) -> dict[str, np.ndarray]:
    """JAX gradient state -> the port's names and layouts, per layer."""
    flat = {".".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(grads)}
    return dict(pair for key, arr in flat.items()
                for pair in _port_entries(key, arr))


@pytest.mark.parametrize("spec", SPECS)
def test_policy_matches_jax(vit_batch, spec):
    """Loss and every gradient of the ViT's cross-entropy under each remat
    policy, against JAX under the same policy."""
    images, labels, params = vit_batch
    jmodel = jax_vit(**_runtime(spec))

    def loss_fn(m):
        return optax.softmax_cross_entropy_with_integer_labels(
            m(jnp.asarray(images)), jnp.asarray(labels)).mean()

    jloss, jgrads = nnx.jit(nnx.value_and_grad(loss_fn))(jmodel)
    tmodel = port_vit(params, **_runtime(spec))
    loss = trainer.classifier_metrics(tmodel(torch.from_numpy(images)),
                                      torch.from_numpy(labels))["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _jax_grads(jgrads)
    got = _port_grads(tmodel)
    assert set(got) == set(want)
    for name, g in got.items():
        assert_grad_close(g.numpy(), want[name], f"{spec}: {name}")


@pytest.fixture(scope="module")
def siglip_inputs():
    rng = np.random.default_rng(2)
    params = jax_params(JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0)))
    images = torch.from_numpy(rng.standard_normal((3, 64, 64, 3),
                                                  np.float32))
    text = torch.from_numpy(rng.integers(0, 100, (3, 8))).long()
    return params, images, text


def _siglip_step(inputs, spec: str = "none", precision: str = "bf16",
                 **runtime):
    """A tiny SigLIP's contrastive loss and gradients (JAX weights), with
    the counts of plain LayerNorm and attention-kernel forwards (softmax,
    sigmoid, int8-QK) in the forward and in the backward (the recompute);
    ``precision`` is applied with ``apply_precision_policy``."""
    params, images, text = inputs
    cfg = configs.with_runtime(tiny_config(configs),
                               **{**_runtime(spec), **runtime})
    model = SigLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    load_jax_params(model, params)
    apply_precision_policy(model, precision)
    model.train()
    calls = {"ln": 0, "flash": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ln, "layer_norm_plain", counted("ln", ln.layer_norm_plain))
        for mod, fn in ((fa, "flash_attention_plain"),
                        (fa, "sigmoid_attention_plain"),
                        (fa8, "flash_attention_int8_plain")):
            mp.setattr(mod, fn, counted("flash", getattr(mod, fn)))
        loss = trainer.contrastive_loss_fn(model, images, text, kind="siglip")
        forward = dict(calls)
        calls.update(ln=0, flash=0)
        loss.backward()
    return loss.detach(), _port_grads(model), forward, dict(calls), model


@pytest.fixture(scope="module")
def no_remat(siglip_inputs):
    return {impl: _siglip_step(siglip_inputs, attn_impl=impl)
            for impl in ("flash", "saveable")}


@pytest.mark.parametrize("spec", POLICIES)
def test_policy_grads_equal_no_remat(siglip_inputs, no_remat, spec):
    """Under every policy the loss and every gradient of the tiny SigLIP
    (both towers, the MAP head) equal the no-remat run's, bit for bit."""
    loss, grads, *_ = _siglip_step(siglip_inputs, spec)
    want_loss, want, *_ = no_remat["saveable" if spec.endswith("attn")
                                   else "flash"]
    assert torch.equal(loss, want_loss)
    for name, g in grads.items():
        assert torch.equal(g, want[name]), (spec, name)


#: plain LayerNorm / flash forwards the recompute runs a step: the tiny
#: SigLIP has 8 block LayerNorms (ln_post, the head's and ln_final are
#: nn.LayerNorm) and 5 flash calls (4 blocks and the MAP probe, which is
#: outside the blocks); "dots" keeps flash o and lse, "+ln" the LayerNorms;
#: the saveable impl runs no flash kernel
RECOMPUTED = {"none": (0, 0), "full": (8, 4), "dots": (8, 0),
              "dots+ln": (0, 0), "dots+act": (8, 0), "dots+ln+act": (0, 0),
              "dots+attn": (8, 0), "dots+ln+act+attn": (0, 0)}


@pytest.mark.parametrize("spec", SPECS)
def test_recompute_counts(siglip_inputs, spec):
    _, _, forward, backward, _ = _siglip_step(siglip_inputs, spec)
    flash = 0 if spec.endswith("attn") else 5
    assert forward == {"ln": 8, "flash": flash}
    assert (backward["ln"], backward["flash"]) == RECOMPUTED[spec]


#: the other attention kernels a block runs: the sigmoid kind (a config's
#: attn_impl) and the int8-QK one (the int8_qk policy); the MAP probe runs
#: the kind too
KERNEL_KINDS = {"sigmoid": ({"attn_impl": "sigmoid"}, "bf16"),
                "int8_qk": ({}, "int8_qk")}


@pytest.mark.parametrize("spec", ["full", "dots"])
@pytest.mark.parametrize("kind", KERNEL_KINDS)
def test_kernel_kind_recompute_counts(siglip_inputs, kind, spec):
    """Every "dots" set keeps the sigmoid and int8-QK kernels' outputs (no
    forward rerun in the backward); full remat reruns the 4 block calls.
    The gradients equal the kind's no-remat ones bit for bit."""
    runtime, precision = KERNEL_KINDS[kind]
    loss, grads, forward, backward, _ = _siglip_step(
        siglip_inputs, spec, precision, **runtime)
    assert forward == {"ln": 8, "flash": 5}
    assert backward == {"ln": 8, "flash": 4 if spec == "full" else 0}
    want_loss, want, *_ = _siglip_step(siglip_inputs, "none", precision,
                                       **runtime)
    assert torch.equal(loss, want_loss)
    for name, g in grads.items():
        assert torch.equal(g, want[name]), (kind, spec, name)


def _held_bytes(inputs, spec: str) -> int:
    """The activation bytes the tiny SigLIP's blocks hold for the backward
    after the forward: without remat the distinct storages autograd saves
    inside them (parameters aside); under a policy the block inputs the
    checkpoint keeps, and the outputs the policy keeps."""
    params = set()
    storages: dict[int, int] = {}

    def hold(t: torch.Tensor) -> None:
        s = t.untyped_storage()
        if s.data_ptr() not in params:
            storages[s.data_ptr()] = s.nbytes()

    def pack(t):
        hold(t)
        return t

    block_forward = Block.forward

    def counted_forward(self, x, mask=None):
        if spec != "none":  # the checkpoint's own hooks stay innermost
            hold(x)
            return block_forward(self, x, mask=mask)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return block_forward(self, x, mask=mask)

    policy_call = remat.SavePolicy.__call__

    def kept(self, ctx, op, *args, **kwargs):
        decision = policy_call(self, ctx, op, *args, **kwargs)
        if (not ctx.is_recompute
                and decision == CheckpointPolicy.MUST_SAVE):
            outputs = ctx.op_output
            for t in (outputs if isinstance(outputs, tuple) else (outputs,)):
                if isinstance(t, torch.Tensor):
                    hold(t)
        return decision

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Block, "forward", counted_forward)
        mp.setattr(remat.SavePolicy, "__call__", kept)
        params_, images, text = inputs
        cfg = configs.with_runtime(tiny_config(configs), **_runtime(spec))
        model = SigLIP(cfg, device="cpu")
        load_jax_params(model, params_)
        params.update(p.untyped_storage().data_ptr()
                      for p in model.parameters())
        loss = trainer.contrastive_loss_fn(model, images, text,
                                           kind="siglip")
        held = sum(storages.values())
        loss.backward()
    return held


def test_held_bytes_fall_along_the_chain(siglip_inputs):
    """The save sets hold what they name and no more: none > dots+ln+act >
    dots+ln > dots > full (the block inputs alone). fc2's output and the
    attention projection's are kept by no set, so dots+ln+act holds less
    than no remat (the order phase 14(a) gates on the card)."""
    held = {spec: _held_bytes(siglip_inputs, spec)
            for spec in ("none", "dots+ln+act", "dots+ln", "dots", "full")}
    order = list(held.values())
    assert all(a > b for a, b in zip(order, order[1:])), held


@pytest.mark.parametrize("spec", SPECS + MALFORMED)
def test_parse_remat_matches_jax(spec):
    try:
        want = jax_configs.parse_remat(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            configs.parse_remat(spec)
        assert str(got.value) == str(e)
        return
    assert configs.parse_remat(spec) == want


@pytest.mark.parametrize("policy", MALFORMED)
def test_malformed_policy_raises_jax_error(policy):
    with pytest.raises(ValueError) as want:
        jax_configs.remat_policy_parts(policy)
    for build in (lambda: configs.with_runtime(tiny_config(configs),
                                               remat=True,
                                               remat_policy=policy),
                  lambda: Transformer(configs.TransformerConfig(
                      width=64, depth=1, num_heads=2, mlp_dim=128,
                      remat=True, remat_policy=policy))):
        with pytest.raises(ValueError) as got:
            build()
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("impl", ["flash", "auto"])
def test_attn_policy_needs_saveable(impl):
    """"+attn" without the saveable impl raises JAX's ValueError (JAX at
    its first trace, the port when the encoder is built)."""
    kw = dict(width=64, depth=1, num_heads=2, mlp_dim=128, remat=True,
              remat_policy="dots+ln+attn", attn_impl=impl)
    jenc = JaxTransformer(jax_configs.TransformerConfig(**kw),
                          rngs=nnx.Rngs(0))
    with pytest.raises(ValueError) as want:
        jenc._remat_policy()
    with pytest.raises(ValueError) as got:
        Transformer(configs.TransformerConfig(**kw))
    assert str(got.value) == str(want.value)


# -- the saveable attention impl ----------------------------------------------

SAVEABLE_CASES = ["plain", "causal", "mask", "bias", "bf16"]


@pytest.mark.parametrize("case", SAVEABLE_CASES)
def test_saveable_attention_matches_jax(case):
    """Output and q/k/v (and bias) gradients against JAX's
    ``saveable_attention``: f32 atol 1e-5 / rtol 1e-5; bf16 (both round
    the probabilities and the output to bf16) within 2^-7 of the largest
    value."""
    rng = np.random.default_rng(4)
    shape = (2, 6, 2, 8)
    q, k, v, do = (rng.standard_normal(shape, np.float32) for _ in range(4))
    kw_np = {}
    if case == "causal":
        kw_np["is_causal"] = True
    if case == "mask":
        mask = np.ones((2, 1, 1, 6), bool)
        mask[0, ..., 4:] = False
        kw_np["mask"] = mask
    if case == "bias":
        kw_np["bias"] = rng.standard_normal((2, 6, 6), np.float32)
    jdtype, tdtype = ((jnp.bfloat16, torch.bfloat16) if case == "bf16"
                      else (jnp.float32, torch.float32))

    def jfn(q, k, v, *bias):
        kw = dict(kw_np, **({"bias": bias[0]} if bias else {}))
        if "mask" in kw:
            kw["mask"] = jnp.asarray(kw["mask"])
        return jax_saveable(q, k, v, **kw)

    jargs = [jnp.asarray(a, jdtype) for a in (q, k, v)]
    if case == "bias":
        jargs.append(jnp.asarray(kw_np["bias"]))
    jout, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(do, jdtype))
    targs = [torch.tensor(a, dtype=tdtype, requires_grad=True)
             for a in (q, k, v)]
    tkw = {}
    if case == "bias":
        targs.append(torch.tensor(kw_np["bias"], requires_grad=True))
        tkw["bias"] = targs[3]
    if case == "mask":
        tkw["mask"] = torch.from_numpy(kw_np["mask"])
    out = attention.dot_product_attention(
        *targs[:3], impl="saveable", is_causal=case == "causal", **tkw)
    out.backward(torch.tensor(do, dtype=tdtype))
    pairs = [(out, jout)] + [(t.grad, j) for t, j in zip(targs, jgrads)]
    for got, want in pairs:
        got = got.detach().float().numpy()
        want = np.asarray(want, np.float32)
        if case == "bf16":
            np.testing.assert_allclose(got, want,
                                       atol=2**-7 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# -- dropout ------------------------------------------------------------------

def test_rate_one_matches_jax(siglip_inputs):
    """At rate 1 in train mode both packages zero every residual branch
    and the post-norm image embeddings, so the towers reduce to their last
    LayerNorms, pooling and projections: image and text embeddings agree
    to 1e-5."""
    params, images, text = siglip_inputs
    jmodel = JaxSigLIP(jax_configs.with_runtime(tiny_config(jax_configs),
                                                dropout=1.0),
                       rngs=nnx.Rngs(0))
    tmodel = SigLIP(configs.with_runtime(tiny_config(configs), dropout=1.0),
                    device="cpu")
    load_jax_params(tmodel, params)
    tmodel.train()
    ji, jt = jnp.asarray(images.numpy()), jnp.asarray(text.numpy())
    with torch.no_grad():
        got = (tmodel.encode_image(images), tmodel.encode_text(text))
    want = (jmodel.encode_image(ji), jmodel.encode_text(jt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    # the zeroed embedding: the image tower's output ignores the pixels
    with torch.no_grad():
        other = tmodel.encode_image(torch.zeros_like(images))
    assert torch.equal(other, got[0])


def _encode(rate: float, seed: int, train: bool, images, text):
    cfg = configs.with_runtime(tiny_config(configs), dropout=rate)
    model = SigLIP(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    model.train(train)
    with torch.no_grad():
        return model.encode_image(images), model.encode_text(text)


def test_rate_zero_and_eval_are_the_identity(siglip_inputs):
    _, images, text = siglip_inputs
    base = _encode(0.0, 5, False, images, text)
    for rate, train in ((0.0, True), (0.3, False)):
        got = _encode(rate, 5, train, images, text)
        assert all(torch.equal(g, b) for g, b in zip(got, base))


def test_same_seed_draws_the_same_masks(siglip_inputs):
    _, images, text = siglip_inputs
    a = _encode(0.3, 5, True, images, text)
    b = _encode(0.3, 5, True, images, text)
    c = _encode(0.3, 6, True, images, text)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_kept_fraction_and_scale():
    """Inverted dropout: kept values are x / (1 - rate), and the kept
    fraction of 10^5 draws lies within 6 binomial sigma of 1 - rate."""
    drop = Dropout(0.1)
    drop.seed_(torch.Generator().manual_seed(0))
    drop.train()
    y = drop(torch.ones(100_000))
    kept = y != 0
    n, p = y.numel(), 0.9
    assert abs(kept.sum().item() - n * p) <= 6 * (n * p * (1 - p)) ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(drop(torch.ones(3)) * 0, torch.zeros(3))
    drop.rate = 1.0
    assert torch.equal(drop(torch.ones(4)), torch.zeros(4))


def test_full_remat_redraws_the_same_masks(siglip_inputs):
    """Under full remat the recompute draws each block's masks again from
    the generator state of the forward: loss and gradients equal the
    no-remat run's bit for bit, and each generator ends where it would
    without remat (one draw per forward, not two)."""
    loss, grads, _, _, model = _siglip_step(siglip_inputs, "none",
                                            dropout=0.1)
    rloss, rgrads, _, _, rmodel = _siglip_step(siglip_inputs, "full",
                                               dropout=0.1)
    assert torch.equal(loss, rloss)
    for name, g in grads.items():
        assert torch.equal(g, rgrads[name]), name
    drops = [(m, r) for m, r in zip(model.modules(), rmodel.modules())
             if isinstance(m, Dropout)]
    assert drops
    for m, r in drops:
        assert torch.equal(m.generator(torch.device("cpu")).get_state(),
                           r.generator(torch.device("cpu")).get_state())


# -- fp8_hybrid under remat ---------------------------------------------------

def _amax(model) -> dict[str, torch.Tensor]:
    return {n: b.clone() for n, b in model.named_buffers()
            if n.endswith("_amax")}


def test_fp8_histories_under_remat_match_jax(vit_batch):
    """Two classifier steps of the tiny ViT under fp8_hybrid and full
    remat: every amax history equals the no-remat run's bit for bit (the
    recompute neither pushes a second time nor reads the pushed value),
    and JAX's under the same remat to rtol 1e-5 (each entry is a max |x|
    of a forward computed in f32 by both)."""
    from jimm_tpu.quant.policy import apply_precision_policy as jax_policy
    from jimm_tpu_torch.quant.policy import apply_precision_policy
    images, labels, params = vit_batch
    ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
    opt_cfg = dict(learning_rate=1e-3, weight_decay=1e-4)
    histories = {}
    for spec in ("none", "full"):
        model = port_vit(params, **_runtime(spec))
        apply_precision_policy(model, "fp8_hybrid")
        opt = trainer.make_optimizer(model, trainer.OptimizerConfig(
            **opt_cfg))
        step = trainer.make_classifier_train_step()
        for _ in range(2):
            step(model, opt, ti, tl)
        histories[spec] = _amax(model)
    assert histories["none"].keys() == histories["full"].keys()
    for name, h in histories["none"].items():
        assert torch.equal(h, histories["full"][name]), name
        assert (h[-2:] > 0).all() and (h[:-2] == 0).all(), name

    jmodel = jax_vit(**_runtime("full"))
    jax_policy(jmodel, "fp8_hybrid")
    from jimm_tpu.train import trainer as jax_trainer
    jopt = jax_trainer.make_optimizer(jmodel, jax_trainer.OptimizerConfig(
        **opt_cfg))
    jstep = jax_trainer.make_classifier_train_step()
    for _ in range(2):
        jstep(jmodel, jopt, jnp.asarray(images), jnp.asarray(labels))
    want = {}
    for path, var in nnx.to_flat_state(nnx.state(jmodel)):
        key = ".".join(str(p) for p in path)
        if key.endswith("_amax"):
            want.update(_port_entries(key, np.asarray(var[...])))
    assert set(want) == set(histories["full"])
    for name, h in histories["full"].items():
        np.testing.assert_allclose(h.numpy(), want[name], rtol=1e-5,
                                   err_msg=name)
