"""The port's CUDA kernels (forward and backward) against their plain
versions, on the card, the masked flash kernels (NaFlex) included.

Marked ``cuda``: run with ``python -m pytest -m cuda tests/test_torch_cuda.py``
on a machine with an H100. Elsewhere every test skips (decided in the
``card`` fixture, never at import or collection). f32 runs with TF32 off and
must agree to 1e-4; bf16 must keep cosine >= 0.999 against the plain version
computed from the same bf16 inputs, and a max abs error within one bf16 step
(2**-7) of the largest reference value, which a uniformly scaled output fails.
"""

import pytest
import torch

from jimm_tpu_torch.ops import flash_attention as fa
from jimm_tpu_torch.ops import layer_norm as ln

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _close(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype) -> None:
    got, want = got.float().flatten(), want.float().flatten()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-4
    else:
        peak = want.abs().max().item()
        if peak <= 1e-6:
            # zero up to rounding (attention over one key: dq = dk = 0), no
            # direction to compare: both sides' rounding noise, held to the
            # absolute bound chip_smoke.py's gate uses there
            assert (got - want).abs().max().item() <= 1e-5
            return
        cos = torch.nn.functional.cosine_similarity(got, want, dim=0)
        assert cos.item() >= 0.999
        assert (got - want).abs().max().item() <= 2.0**-7 * peak + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,f", [(1, 64), (7, 80), (300, 768),
                                    (8192, 768), (3, 5000), (300, 1024),
                                    (300, 1152), (8192, 1152)])
def test_layer_norm_kernel(card, rows, f, dtype):
    """Every preset width (768, 1024, 1152) and (1, 64), (7, 80) on the
    register body; (3, 5000) on the CTA body."""
    g = torch.Generator(device=card).manual_seed(rows + f)
    x = (torch.randn(rows, f, generator=g, device=card) * 3 + 0.5).to(dtype)
    w = torch.randn(f, generator=g, device=card).to(dtype)
    b = torch.randn(f, generator=g, device=card).to(dtype)
    assert ln.forward_body(x, w, b) == ("cta" if f > 2048 else "register")
    before = ln.launches
    y, mu, rstd = ln.layer_norm_fwd(x, w, b, 1e-6)
    torch.cuda.synchronize()
    assert ln.launches == before + 1
    want_y, want_mu, want_rstd = ln.layer_norm_plain(x, w, b, 1e-6)
    assert y.dtype == dtype and mu.dtype == rstd.dtype == torch.float32
    _close(y, want_y, dtype)
    _close(mu, want_mu, torch.float32)
    torch.testing.assert_close(rstd, want_rstd, atol=1e-4, rtol=1e-4)


def _launched(fn) -> list[str]:
    """The names of the kernels ``fn()`` launches, from a profiler trace."""
    for _ in range(3):  # a trace now and then has no device rows
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,f,offset", [(300, 768, 0), (300, 1152, 0),
                                           (3, 5000, 0), (300, 768, 4)])
def test_layer_norm_forward_runs_the_body_forward_body_names(card, rows, f,
                                                             offset, dtype):
    """The C entry picks the body ``ln.forward_body`` names: a trace shows
    that body's kernel and not the other's; x 4 bytes off a 16-byte
    boundary takes the CTA body."""
    g = torch.Generator(device=card).manual_seed(rows + f + offset)
    x = (torch.randn(rows, f, generator=g, device=card) * 3 + 0.5).to(dtype)
    w = torch.randn(f, generator=g, device=card).to(dtype)
    b = torch.randn(f, generator=g, device=card).to(dtype)
    if offset:
        skip = offset // x.element_size()
        store = torch.empty(x.numel() + skip, dtype=dtype, device=card)
        store[skip:] = x.flatten()
        x = store[skip:].view(rows, f)
    body = ln.forward_body(x, w, b)
    assert body == ("register" if f <= 2048 and not offset else "cta")
    names = _launched(lambda: ln.layer_norm_fwd(x, w, b, 1e-6))
    for kind, kernel in ln.FORWARD_KERNELS.items():
        assert any(kernel + "<" in n for n in names) == (kind == body), names
    y, mu, rstd = ln.layer_norm_fwd(x, w, b, 1e-6)
    want_y, want_mu, want_rstd = ln.layer_norm_plain(x, w, b, 1e-6)
    _close(y, want_y, dtype)
    _close(mu, want_mu, torch.float32)
    torch.testing.assert_close(rstd, want_rstd, atol=1e-4, rtol=1e-4)


_FLASH = [((32, 256, 12, 64), 256, False),   # image self-attention
          ((32, 1, 12, 64), 256, False),     # MAP probe
          ((32, 64, 12, 64), 64, False),     # text self-attention
          ((2, 5, 2, 80), 5, True), ((2, 257, 2, 64), 257, True),
          ((2, 1, 2, 32), 257, False), ((2, 257, 2, 80), 257, False),
          ((1, 70, 1, 256), 130, True), ((2, 257, 2, 256), 257, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qshape,sk,causal", _FLASH)
def test_flash_attention_kernel(card, qshape, sk, causal, dtype):
    g = torch.Generator(device=card).manual_seed(sum(qshape) + sk)
    b, sq, n, d = qshape
    q = torch.randn(b, sq, n, d, generator=g, device=card).to(dtype)
    k, v = (torch.randn(b, sk, n, d, generator=g, device=card).to(dtype)
            for _ in range(2))
    before = fa.launches
    o, lse = fa.flash_attention_lse(q, k, v, is_causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want_o, want_lse = fa.flash_attention_plain(q, k, v, is_causal=causal)
    assert o.shape == q.shape and lse.shape == (b, n, sq)
    _close(o, want_o, dtype)
    # both widen bf16 to f32 exactly and run the softmax in f32
    _close(lse, want_lse, torch.float32)


def test_flash_reads_strided_views(card):
    """fused q/k/v: strided views of one (B, S, 3, N, D) tensor, no copy."""
    g = torch.Generator(device=card).manual_seed(5)
    qkv = torch.randn(4, 100, 3 * 6 * 64, generator=g, device=card)
    q, k, v = (t.reshape(4, 100, 6, 64) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    o = fa.flash_attention(q, k, v)
    _close(o, fa.flash_attention_plain(q, k, v)[0], torch.float32)


def test_siglip_forward_on_the_card(card):
    """A small SigLIP through both kernels matches the same model with the
    attention and LayerNorm on the plain path."""
    from jimm_tpu_torch import configs
    from jimm_tpu_torch.models.siglip import SigLIP
    cfg = configs.SigLIPConfig(
        vision=configs.VisionConfig(image_size=64, patch_size=16, width=128,
                                    depth=2, num_heads=2, mlp_dim=256,
                                    act="gelu_tanh", pooling="map"))
    kernels = SigLIP(configs.with_runtime(cfg, attn_impl="flash",
                                          ln_impl="fused"), device=card)
    plain = SigLIP(configs.with_runtime(cfg, attn_impl="xla",
                                        ln_impl="xla"), device=card)
    plain.load_state_dict(kernels.state_dict())
    images = torch.randn(3, 64, 64, 3, device=card)
    f0, l0 = fa.launches, ln.launches
    with torch.no_grad():
        got = kernels.encode_image(images)
        want = plain.encode_image(images)
    assert fa.launches - f0 == 3 and ln.launches - l0 == 4
    _close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,f", [(1, 64), (7, 80), (300, 768),
                                    (32768, 768), (3, 5000), (8192, 768),
                                    (8192, 1024), (8192, 1152)])
def test_layer_norm_backward_kernel(card, rows, f, dtype):
    """Every preset width (768, 1024, 1152), the train step's image and
    text rows, (1, 64) and (7, 80) on the register body; (3, 5000) on the
    CTA body."""
    g = torch.Generator(device=card).manual_seed(rows * 3 + f)
    x = (torch.randn(rows, f, generator=g, device=card) * 3 + 0.5).to(dtype)
    w = torch.randn(f, generator=g, device=card).to(dtype)
    dy = torch.randn(rows, f, generator=g, device=card).to(dtype)
    _, mu, rstd = ln.layer_norm_plain(x, w, w, 1e-6)
    before = ln.bwd_launches
    got = ln.layer_norm_bwd(x, w, mu, rstd, dy)
    torch.cuda.synchronize()
    assert ln.bwd_launches == before + 1
    want = ln.layer_norm_bwd_plain(x, w, mu, rstd, dy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype
        # dscale/dbias sum over all rows: f32 error grows with the row count
        _close(a / max(1.0, b.float().abs().max().item()),
               b / max(1.0, b.float().abs().max().item()), dtype)


def _ln_bwd_inputs(rows: int, f: int, dtype: torch.dtype, card,
                   x_offset: int = 0):
    """x (``x_offset`` bytes past a 16-byte boundary), scale, mean, rstd and
    dy of a LayerNorm backward, from a seeded generator."""
    g = torch.Generator(device=card).manual_seed(rows + f + x_offset)
    x = (torch.randn(rows, f, generator=g, device=card) * 3 + 0.5).to(dtype)
    w = torch.randn(f, generator=g, device=card).to(dtype)
    dy = torch.randn(rows, f, generator=g, device=card).to(dtype)
    if x_offset:
        skip = x_offset // x.element_size()
        store = torch.empty(x.numel() + skip, dtype=dtype, device=card)
        store[skip:] = x.flatten()
        x = store[skip:].view(rows, f)
    _, mu, rstd = ln.layer_norm_plain(x, w, w, 1e-6)
    return x, w, mu, rstd, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,f,offset", [(300, 768, 0), (300, 1152, 0),
                                           (3, 5000, 0), (300, 768, 4),
                                           (5, 2048, 0), (5, 2056, 0)])
def test_layer_norm_backward_runs_the_body_backward_body_names(card, rows, f,
                                                               offset, dtype):
    """The C entry picks the body ``ln.backward_body`` names: a trace shows
    that body's kernel and not the other's; x 4 bytes off a 16-byte
    boundary, and rows wider than the register body takes (2048), take the
    CTA body."""
    x, w, mu, rstd, dy = _ln_bwd_inputs(rows, f, dtype, card, offset)
    body = ln.backward_body(x, w, dy)
    assert body == ("cta" if offset or f > 2048 else "register")
    names = _launched(lambda: ln.layer_norm_bwd(x, w, mu, rstd, dy))
    for kind, kernel in ln.BACKWARD_KERNELS.items():
        assert any(kernel + "<" in n for n in names) == (kind == body), names
    got = ln.layer_norm_bwd(x, w, mu, rstd, dy)
    want = ln.layer_norm_bwd_plain(x, w, mu, rstd, dy)
    for a, b in zip(got, want):
        scale = max(1.0, b.float().abs().max().item())
        _close(a / scale, b / scale, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_backward_is_the_same_in_every_run(card, dtype):
    """dscale and dbias are per-CTA partial rows summed in a fixed order,
    with no atomics: two runs give the same bits, on both bodies (the train
    shape on the register body, x off 16 bytes on the CTA body)."""
    for rows, f, offset in ((32768, 768, 0), (8192, 1152, 0),
                            (300, 768, 4)):
        x, w, mu, rstd, dy = _ln_bwd_inputs(rows, f, dtype, card, offset)
        runs = [ln.layer_norm_bwd(x, w, mu, rstd, dy) for _ in range(2)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs))


_FLASH_BWD = _FLASH + [((128, 256, 12, 64), 256, False),   # train image
                       ((128, 1, 12, 64), 256, False),     # train probe
                       ((128, 64, 12, 64), 64, False)]     # train text


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qshape,sk,causal", _FLASH_BWD)
def test_flash_attention_backward_kernel(card, qshape, sk, causal, dtype):
    g = torch.Generator(device=card).manual_seed(sum(qshape) * 7 + sk)
    b, sq, n, d = qshape
    q, do = (torch.randn(b, sq, n, d, generator=g, device=card).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, n, d, generator=g, device=card).to(dtype)
            for _ in range(2))
    dlse = torch.randn(b, n, sq, generator=g, device=card)
    o, lse = fa.flash_attention_plain(q, k, v, is_causal=causal)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, dlse, is_causal=causal)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, dlse,
                                        is_causal=causal)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == dtype
        # scaled to the reference's largest value, as the f32 tolerance is
        scale = max(1.0, w.float().abs().max().item())
        _close(a / scale, w / scale, dtype)


def test_siglip_grads_on_the_card(card):
    """Every parameter of a small SigLIP gets a finite gradient through the
    kernels, matching the same model with the plain versions."""
    from jimm_tpu_torch import configs
    from jimm_tpu_torch.models.siglip import SigLIP
    from jimm_tpu_torch.train.trainer import contrastive_loss_fn
    cfg = configs.SigLIPConfig(
        vision=configs.VisionConfig(image_size=64, patch_size=16, width=128,
                                    depth=2, num_heads=2, mlp_dim=256,
                                    act="gelu_tanh", pooling="map"),
        text=configs.TextConfig(vocab_size=100, context_length=8, width=128,
                                depth=2, num_heads=2, mlp_dim=256,
                                act="gelu_tanh", causal=False,
                                pooling="last", proj_bias=True),
        projection_dim=128)
    kernels = SigLIP(configs.with_runtime(cfg, attn_impl="flash",
                                          ln_impl="fused"), device=card)
    plain = SigLIP(configs.with_runtime(cfg, attn_impl="xla",
                                        ln_impl="xla"), device=card)
    plain.load_state_dict(kernels.state_dict())
    g = torch.Generator(device=card).manual_seed(9)
    images = torch.randn(4, 64, 64, 3, generator=g, device=card)
    text = torch.randint(0, 100, (4, 8), generator=g, device=card)
    f0, l0 = fa.bwd_launches, ln.bwd_launches
    contrastive_loss_fn(kernels, images, text, kind="siglip").backward()
    assert fa.bwd_launches - f0 == 5 and ln.bwd_launches - l0 == 8
    contrastive_loss_fn(plain, images, text, kind="siglip").backward()
    want = {n: p.grad for n, p in plain.named_parameters()}
    # within 1e-3 of each parameter's largest gradient, or, for a gradient
    # that is zero in exact arithmetic (the k-projection bias: softmax does
    # not see a per-row shift of the scores), of 1e-3 of the model's largest
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    for name, p in kernels.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        ref = want[name]
        peak = max(ref.abs().max().item(), floor)
        assert (p.grad - ref).abs().max().item() <= 1e-3 * peak, name


# -- masked flash (kernel row 4, row 7's mask kind) ---------------------------

def _key_mask(kind: str, b: int, sk: int, g: torch.Generator,
              device) -> torch.Tensor:
    """(B, Sk) bool, True = attend: ``naflex``, the synthetic NaFlex
    batches' real-token counts (243, 256, 243, 242 of 256) in turn;
    ``sparse``, most keys padded; ``len64``, a 64-key prefix; ``empty_row``,
    sample 1 with no valid key."""
    cols = torch.arange(sk, device=device)
    if kind == "naflex":
        lengths = torch.tensor([243, 256, 243, 242], device=device).repeat(
            (b + 3) // 4)[:b]
        return cols[None, :] < lengths[:, None]
    if kind == "len64":
        return (cols < 64)[None, :].expand(b, sk).contiguous()
    m = torch.rand(b, sk, generator=g, device=device) > 0.7
    m[:, 0] = True
    if kind == "empty_row":
        m[1] = False
    return m


def _live(mask: torch.Tensor, sq: int, causal: bool) -> torch.Tensor:
    """(B, Sq) bool: query rows with at least one key to attend."""
    keep = mask[:, None, :].expand(-1, sq, -1)
    if causal:
        keep = keep & torch.ones(sq, mask.shape[1], dtype=torch.bool,
                                 device=mask.device).tril()
    return keep.any(-1)


_MASKED = [((128, 256, 12, 64), 256, False, "naflex"),   # NaFlex image
           ((128, 1, 12, 64), 256, False, "naflex"),     # NaFlex MAP probe
           ((2, 5, 2, 80), 5, True, "sparse"),
           ((2, 257, 2, 64), 257, False, "len64"),
           ((2, 1, 2, 80), 257, False, "sparse"),
           ((2, 65, 2, 64), 65, False, "empty_row"),
           ((1, 70, 1, 256), 130, True, "sparse")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qshape,sk,causal,kind", _MASKED)
def test_masked_flash_kernel(card, qshape, sk, causal, kind, dtype):
    g = torch.Generator(device=card).manual_seed(sum(qshape) + sk + 1)
    b, sq, n, d = qshape
    q = torch.randn(b, sq, n, d, generator=g, device=card).to(dtype)
    k, v = (torch.randn(b, sk, n, d, generator=g, device=card).to(dtype)
            for _ in range(2))
    mask = _key_mask(kind, b, sk, g, card)
    before, plain_before = fa.masked_launches, fa.launches
    o, lse = fa.flash_attention_lse(q, k, v, is_causal=causal, mask=mask)
    torch.cuda.synchronize()
    assert fa.masked_launches == before + 1 and fa.launches == plain_before
    want_o, want_lse = fa.flash_attention_plain(q, k, v, is_causal=causal,
                                                mask=mask)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    # a row with no key to attend is finite garbage that depends on the
    # tile padding: compared only where there is a key
    live = _live(mask, sq, causal)
    _close(o[live], want_o[live], dtype)
    _close(lse.transpose(1, 2)[live], want_lse.transpose(1, 2)[live],
           torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qshape,sk,causal,kind", _MASKED)
def test_masked_flash_backward_kernel(card, qshape, sk, causal, kind, dtype):
    g = torch.Generator(device=card).manual_seed(sum(qshape) * 5 + sk)
    b, sq, n, d = qshape
    q, do = (torch.randn(b, sq, n, d, generator=g, device=card).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, n, d, generator=g, device=card).to(dtype)
            for _ in range(2))
    mask = _key_mask(kind, b, sk, g, card)
    live = _live(mask, sq, causal)
    do = do * live[:, :, None, None].to(dtype)  # no cotangent on dead rows
    o, lse = fa.flash_attention_plain(q, k, v, is_causal=causal, mask=mask)
    before = fa.masked_bwd_launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, is_causal=causal,
                                 mask=mask)
    torch.cuda.synchronize()
    assert fa.masked_bwd_launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                        is_causal=causal, mask=mask)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == dtype
        scale = max(1.0, w.float().abs().max().item())
        _close(a / scale, w / scale, dtype)
    # masked keys get exactly zero gradient
    assert not got[1][~mask].any() and not got[2][~mask].any()


def test_siglip2_naflex_grads_on_the_card(card):
    """A small SigLIP2 trains on a NaFlex batch through the masked kernels
    (2 vision blocks + the MAP probe) and the unmasked ones (2 text
    blocks); every gradient matches the same model on the plain path."""
    import numpy as np
    from jimm_tpu_torch import configs
    from jimm_tpu_torch.data.synthetic import naflex_contrastive_pairs
    from jimm_tpu_torch.models.siglip import SigLIP
    from jimm_tpu_torch.train.trainer import contrastive_loss_fn
    cfg = configs.SigLIPConfig(
        vision=configs.VisionConfig(image_size=64, patch_size=16, width=128,
                                    depth=2, num_heads=2, mlp_dim=256,
                                    act="gelu_tanh", pooling="map"),
        text=configs.TextConfig(vocab_size=100, context_length=8, width=128,
                                depth=2, num_heads=2, mlp_dim=256,
                                act="gelu_tanh", causal=False,
                                pooling="last", proj_bias=True),
        projection_dim=128)
    kernels = SigLIP(configs.with_runtime(cfg, attn_impl="flash",
                                          ln_impl="fused"), device=card)
    plain = SigLIP(configs.with_runtime(cfg, attn_impl="xla",
                                        ln_impl="xla"), device=card)
    plain.load_state_dict(kernels.state_dict())
    (patches, shapes, mask), text = next(naflex_contrastive_pairs(
        4, patch_size=16, max_num_patches=16, vocab_size=100, seed=4))
    assert not mask.all()
    images = (torch.from_numpy(patches).to(card),
              torch.from_numpy(shapes).to(card),
              torch.from_numpy(mask).to(card))
    text = torch.from_numpy(np.asarray(text)).long().to(card)
    m0, f0 = fa.masked_bwd_launches, fa.bwd_launches
    contrastive_loss_fn(kernels, images, text, kind="siglip").backward()
    assert fa.masked_bwd_launches - m0 == 3 and fa.bwd_launches - f0 == 2
    contrastive_loss_fn(plain, images, text, kind="siglip").backward()
    want = {n: p.grad for n, p in plain.named_parameters()}
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    for name, p in kernels.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        ref = want[name]
        peak = max(ref.abs().max().item(), floor)
        assert (p.grad - ref).abs().max().item() <= 1e-3 * peak, name


# -- int8 kernels (rows 9, 10 and 11) -----------------------------------------

#: (M, K, N): tests/test_int8_ops.py's odd shapes and the served ones
_INT8_MATMUL = [(1, 7, 5), (5, 100, 33), (33, 64, 128), (257, 769, 129),
                (16, 768, 768), (8192, 768, 3072), (8192, 3072, 768),
                (32, 768, 768), (8192, 768, 768), (70, 97, 40)]


def _int8_operands(m: int, k: int, n: int, device):
    from jimm_tpu_torch.ops import int8_matmul as mm
    g = torch.Generator(device=device).manual_seed(m * 7 + k + n)
    x = torch.randn(m, k, generator=g, device=device)
    w = torch.randn(n, k, generator=g, device=device)
    bias = torch.randn(n, generator=g, device=device)
    x_q, x_s = mm.quantize_rows(x)
    w_q, w_s = mm.quantize_rows(w)  # per output channel over K
    return x_q, x_s, w_q, w_s, bias


@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
@pytest.mark.parametrize("m,k,n", _INT8_MATMUL)
def test_int8_matmul_kernel(card, m, k, n, activation):
    """Exact s32 sums and the same rounded epilogue: equal to the plain
    version (f64 sums) up to gelu's erff."""
    from jimm_tpu_torch.ops import int8_matmul as mm
    x_q, x_s, w_q, w_s, bias = _int8_operands(m, k, n, card)
    before = mm.launches
    got = mm.int8_matmul(x_q, x_s, w_q, w_s, bias, activation=activation)
    torch.cuda.synchronize()
    assert mm.launches == before + 1
    want = mm.int8_matmul_plain(x_q, x_s, w_q, w_s, bias,
                                activation=activation)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    if activation == "gelu":
        _close(got, want, torch.float32)
    else:
        assert torch.equal(got, want)


def test_int8_matmul_kernel_without_bias_and_unaligned(card):
    """No bias, K off a multiple of 16, and x_q off a 16-byte boundary: the
    wrapper's zero-padded copies (TMA reads neither as given); one launch
    a call still."""
    from jimm_tpu_torch.ops import int8_matmul as mm
    x_q, x_s, w_q, w_s, _ = _int8_operands(70, 97, 40, card)
    got = mm.int8_matmul(x_q, x_s, w_q, w_s)
    assert torch.equal(got, mm.int8_matmul_plain(x_q, x_s, w_q, w_s))
    x_q2, x_s2, w_q2, w_s2, _ = _int8_operands(64, 96, 40, card)
    x_off = torch.empty(64 * 96 + 4, dtype=torch.int8, device=card)
    x_off[4:] = x_q2.flatten()
    x_view = x_off[4:].view(64, 96)
    before = mm.launches
    got = mm.int8_matmul(x_view, x_s2, w_q2, w_s2)
    assert mm.launches == before + 1
    assert torch.equal(got, mm.int8_matmul_plain(x_q2, x_s2, w_q2, w_s2))


_INT8_FLASH = [((128, 256, 12, 64), 256, False),   # train image
               ((128, 1, 12, 64), 256, False),     # train MAP probe
               ((128, 64, 12, 64), 64, False),     # train text
               ((2, 1, 2, 64), 1, False), ((2, 5, 2, 80), 5, True),
               ((2, 257, 2, 64), 257, True), ((2, 257, 2, 80), 257, False),
               ((2, 1, 2, 80), 257, False), ((1, 70, 1, 256), 130, True),
               ((1, 9, 2, 30), 9, False)]          # D not a multiple of 4


def _int8_flash_inputs(qshape, sk, dtype, device, seed):
    from jimm_tpu_torch.ops import flash_attention_int8 as fa8
    g = torch.Generator(device=device).manual_seed(seed)
    b, sq, n, d = qshape
    q, do = (torch.randn(b, sq, n, d, generator=g, device=device).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, n, d, generator=g, device=device).to(dtype)
            for _ in range(2))
    qq, qs = fa8.quantize_heads(q)
    kq, ks = fa8.quantize_heads(k)
    return qq, qs, kq, ks, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qshape,sk,causal", _INT8_FLASH)
def test_flash_int8_kernel(card, qshape, sk, causal, dtype):
    from jimm_tpu_torch.ops import flash_attention_int8 as fa8
    qq, qs, kq, ks, v, _ = _int8_flash_inputs(qshape, sk, dtype, card,
                                              sum(qshape) + sk)
    before, plain_before = fa8.launches, fa.launches
    o, lse = fa8.flash_attention_int8_fwd(qq, qs, kq, ks, v,
                                          is_causal=causal)
    torch.cuda.synchronize()
    assert fa8.launches == before + 1 and fa.launches == plain_before
    want_o, want_lse = fa8.flash_attention_int8_plain(qq, qs, kq, ks, v,
                                                      is_causal=causal)
    assert o.shape == qshape and o.dtype == dtype
    _close(o, want_o, dtype)
    _close(lse, want_lse, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qshape,sk,causal", _INT8_FLASH)
def test_flash_int8_backward_kernel(card, qshape, sk, causal, dtype):
    from jimm_tpu_torch.ops import flash_attention_int8 as fa8
    qq, qs, kq, ks, v, do = _int8_flash_inputs(qshape, sk, dtype, card,
                                               sum(qshape) * 3 + sk)
    o, lse = fa8.flash_attention_int8_plain(qq, qs, kq, ks, v,
                                            is_causal=causal)
    before = fa8.bwd_launches
    got = fa8.flash_attention_int8_bwd(qq, qs, kq, ks, v, o, lse, do,
                                       is_causal=causal)
    torch.cuda.synchronize()
    assert fa8.bwd_launches == before + 1
    want = fa8.flash_attention_int8_bwd_plain(qq, qs, kq, ks, v, o, lse, do,
                                              is_causal=causal)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == dtype
        scale = max(1.0, w.float().abs().max().item())
        if w.float().abs().max().item() <= 1e-6:
            # one key: dq = dk = 0 in exact arithmetic, rounding on both
            # sides, which has no direction to compare
            assert (a.float() - w.float()).abs().max().item() <= 1e-5
        else:
            _close(a / scale, w / scale, dtype)


def test_int8_wrappers_never_take_the_plain_version_on_the_card(card,
                                                                monkeypatch):
    """A CUDA call launches the kernel and counts it; the plain versions are
    not entered, and a kernel that cannot take its operands raises."""
    from jimm_tpu_torch.ops import flash_attention_int8 as fa8
    from jimm_tpu_torch.ops import int8_matmul as mm

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    for mod, name in ((mm, "int8_matmul_plain"),
                      (fa8, "flash_attention_int8_plain"),
                      (fa8, "flash_attention_int8_bwd_plain")):
        monkeypatch.setattr(mod, name, refuse)
    x_q, x_s, w_q, w_s, bias = _int8_operands(9, 40, 17, card)
    before = mm.launches
    mm.int8_matmul(x_q, x_s, w_q, w_s, bias)
    assert mm.launches == before + 1
    q, k, v = (torch.randn(2, 9, 2, 16, device=card, requires_grad=True)
               for _ in range(3))
    f0, b0 = fa8.launches, fa8.bwd_launches
    fa8.flash_attention_int8(q, k, v).sum().backward()
    torch.cuda.synchronize()
    assert (fa8.launches, fa8.bwd_launches) == (f0 + 1, b0 + 1)
    with pytest.raises(ValueError):
        mm.int8_matmul(x_q, x_s, w_q, w_s.double(), bias)
    with pytest.raises(ValueError):
        fa8.flash_attention_int8(q.double(), k.double(), v.double())


def test_siglip_int8_and_int8_qk_on_the_card(card, monkeypatch):
    """A small SigLIP quantized for serving runs its Linears on the int8
    matmul and matches the plain-version forward; under int8_qk its
    gradients match the plain versions'."""
    from jimm_tpu_torch import configs
    from jimm_tpu_torch.models.siglip import SigLIP
    from jimm_tpu_torch.ops import flash_attention_int8 as fa8
    from jimm_tpu_torch.ops import int8_matmul as mm
    from jimm_tpu_torch.quant import quantize_model
    from jimm_tpu_torch.quant.policy import apply_precision_policy
    from jimm_tpu_torch.train.trainer import contrastive_loss_fn
    cfg = configs.SigLIPConfig(
        vision=configs.VisionConfig(image_size=64, patch_size=16, width=128,
                                    depth=2, num_heads=2, mlp_dim=256,
                                    act="gelu_tanh", pooling="map"),
        text=configs.TextConfig(vocab_size=100, context_length=8, width=128,
                                depth=2, num_heads=2, mlp_dim=256,
                                act="gelu_tanh", causal=False,
                                pooling="last", proj_bias=True),
        projection_dim=128)
    cfg = configs.with_runtime(cfg, attn_impl="flash", ln_impl="fused")
    model = SigLIP(cfg, device=card)
    assert quantize_model(model) == 31
    images = torch.randn(3, 64, 64, 3, device=card)
    before = mm.launches
    with torch.no_grad():
        got = model.encode_image(images)
    assert mm.launches - before == 18   # 2 blocks x 6 + the MAP head's 6
    cpu = SigLIP(cfg, device="cpu")
    quantize_model(cpu)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        want = cpu.encode_image(images.cpu())
    # a one-ulp difference upstream can move one int8 activation by a step:
    # the served-feature bounds of chip_smoke.py, per image
    got = got.cpu()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert (cos >= 0.999).all()
    assert ((got.norm(dim=1) / want.norm(dim=1) - 1).abs() <= 1e-2).all()

    kernels = SigLIP(cfg, device=card)
    plain = SigLIP(cfg, device="cpu")
    plain.load_state_dict({k: v.cpu() for k, v in kernels.state_dict().items()})
    assert apply_precision_policy(kernels, "int8_qk") == 5
    apply_precision_policy(plain, "int8_qk")
    g = torch.Generator(device=card).manual_seed(9)
    images = torch.randn(4, 64, 64, 3, generator=g, device=card)
    text = torch.randint(0, 100, (4, 8), generator=g, device=card)
    # the CPU step quantizes q and k as the card's step did: a one-ulp
    # difference upstream of a quantizer can move an int8 value by a step
    # and a gradient by ~2e-3 of its largest value, which is the quantized
    # function's discontinuity, not a kernel's error
    quantize, tape = fa8.quantize_heads, []

    def record(x):
        tape.append(quantize(x))
        return tape[-1]

    replayed = iter(tape)

    def replay(x):
        x_q, scale = next(replayed)
        assert x_q.shape == x.shape
        return x_q.to(x.device), scale.to(x.device)

    b0 = fa8.bwd_launches
    monkeypatch.setattr(fa8, "quantize_heads", record)
    contrastive_loss_fn(kernels, images, text, kind="siglip").backward()
    assert fa8.bwd_launches - b0 == 5
    monkeypatch.setattr(fa8, "quantize_heads", replay)
    contrastive_loss_fn(plain, images.cpu(), text.cpu(),
                        kind="siglip").backward()
    want = {n: p.grad for n, p in plain.named_parameters()}
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    for name, p in kernels.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        ref = want[name]
        peak = max(ref.abs().max().item(), floor)
        assert (p.grad.cpu() - ref).abs().max().item() <= 1e-3 * peak, name


# -- fp8 GEMM (row 12) and sigmoid flash (row 6, row 7's sigmoid kind) --------

#: (M, K, N): tests/test_fp8_ops.py's odd shapes and the train step's
_FP8_GEMM = [(1, 7, 5), (5, 100, 33), (33, 64, 128), (257, 769, 129),
             (16, 768, 768), (32768, 768, 3072), (8192, 3072, 768),
             (768, 32768, 768), (128, 768, 768)]


def _fp8_operands(m: int, k: int, n: int, a_dtype, device):
    """a (M, K) and b (N, K) fp8 at their dynamic scales, their combined
    scale and an f32 bias."""
    from jimm_tpu_torch.ops import fp8_matmul as fp8
    g = torch.Generator(device=device).manual_seed(m + 3 * k + n)
    a = torch.randn(m, k, generator=g, device=device)
    b = torch.randn(n, k, generator=g, device=device)
    bias = torch.randn(n, generator=g, device=device)
    sa, sb = fp8.dynamic_scale(a, a_dtype), fp8.dynamic_scale(b, fp8.E4M3)
    return (fp8.quantize_tensor(a, sa, a_dtype),
            fp8.quantize_tensor(b, sb, fp8.E4M3), sa * sb, bias)


def _fp8_gate(a_q, b_q, scale, bias, got) -> None:
    """Row 12's gate, ``fp8_matmul.check_gemm`` (chip_smoke.py's too):
    within ``gemm_error_bound`` of the plain version, and the epilogue bit
    for bit."""
    from jimm_tpu_torch.ops import fp8_matmul as fp8
    excess, _, epilogue_exact, _ = fp8.check_gemm(a_q, b_q, scale, bias, got)
    assert excess <= 0
    assert epilogue_exact


@pytest.mark.parametrize("a_fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("m,k,n", _FP8_GEMM)
def test_fp8_gemm_kernel(card, m, k, n, a_fmt):
    """The tensor core sums in f32 with truncation, in its own order: held
    to ``fp8_matmul.gemm_error_bound`` against the plain version (f32
    matmul of the widened fp8 values, TF32 off), with the epilogue (scale,
    then bias) exact."""
    from jimm_tpu_torch.ops import fp8_matmul as fp8
    a_q, b_q, scale, bias = _fp8_operands(
        m, k, n, fp8.E4M3 if a_fmt == "e4m3" else fp8.E5M2, card)
    before, bwd_before = fp8.launches, fp8.bwd_launches
    got = fp8.fp8_gemm(a_q, b_q, scale, bias)
    no_bias = fp8.fp8_gemm(a_q, b_q, scale, backward=True)
    torch.cuda.synchronize()
    assert (fp8.launches, fp8.bwd_launches) == (before + 1, bwd_before + 1)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _fp8_gate(a_q, b_q, scale, bias, got)
    _fp8_gate(a_q, b_q, scale, None, no_bias)
    assert torch.equal(got, no_bias + bias)


def test_fp8_gemm_kernel_unaligned(card):
    """An operand off a 16-byte boundary, and K off a multiple of 16, reach
    the kernel as the wrapper's zero-padded copies (TMA needs both); the
    kernel's entry point refuses them unpadded."""
    from jimm_tpu_torch import _build
    from jimm_tpu_torch.ops import fp8_matmul as fp8
    a_q, b_q, scale, _ = _fp8_operands(64, 96, 40, fp8.E4M3, card)
    off = torch.empty(64 * 96 + 4, dtype=torch.uint8, device=card)
    off[4:] = a_q.view(torch.uint8).flatten()
    a_view = off[4:].view(64, 96).view(fp8.E4M3)
    assert a_view.data_ptr() % 16 != 0
    got = fp8.fp8_gemm(a_view, b_q, scale)
    _fp8_gate(a_q, b_q, scale, None, got)
    a_q, b_q, scale, _ = _fp8_operands(33, 100, 20, fp8.E4M3, card)
    _fp8_gate(a_q, b_q, scale, None, fp8.fp8_gemm(a_q, b_q, scale))
    out = torch.empty(33, 20, device=card)
    stream = torch.cuda.current_stream().cuda_stream
    for a, k in ((a_q, 100), (a_view, 96)):
        rc = _build.load().jimm_fp8_matmul(
            a.data_ptr(), b_q.data_ptr(), scale.data_ptr(), None,
            out.data_ptr(), None, 33, 20, k, 128, 0, 0, stream)
        assert rc != 0


@pytest.mark.parametrize("a_fmt", ["e4m3", "e5m2"])
def test_fp8_gemm_sums_in_f32(card, a_fmt):
    """Rows of 256 then ones over K = 32768: every output is 65536 + 32767,
    exact in f32. An accumulator of fp8 wgmma's ~14 bits drops the ones
    (all of them carried over K, 31 promoted after every instruction); the
    kernel's f32 sums keep them. At the q/k/v/out weight gradients' shape,
    768 x 768, K is summed in 15 ranges, the last 512 long: a dropped or
    doubled range is off by its length."""
    from jimm_tpu_torch.ops import fp8_matmul as fp8
    assert fp8.k_range(768, 768, 32768, 132) == 2304
    a = torch.ones(768, 32768, device=card)
    b = torch.ones(768, 32768, device=card)
    a[:, 0] = b[:, 0] = 256.0
    a_q = a.to(fp8.E4M3 if a_fmt == "e4m3" else fp8.E5M2)
    b_q = b.to(fp8.E4M3)
    one = torch.ones((), device=card)
    got = fp8.fp8_gemm(a_q, b_q, one)
    torch.cuda.synchronize()
    assert (got == 65536 + 32767).all()
    _fp8_gate(a_q, b_q, one, None, got)


_SIGMOID = [(qshape, sk, causal, None) for qshape, sk, causal in _FLASH] + [
    ((128, 256, 12, 64), 256, False, None),      # train image
    ((128, 1, 12, 64), 256, False, None),        # train MAP probe
    ((128, 64, 12, 64), 64, False, None),        # train text
    ((2, 5, 2, 80), 5, True, "sparse"), ((2, 257, 2, 64), 257, False, "len64"),
    ((2, 65, 2, 64), 65, False, "empty_row"),
    ((1, 70, 1, 256), 130, True, "sparse")]


def _sigmoid_inputs(qshape, sk, kind, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    b, sq, n, d = qshape
    q, do = (torch.randn(b, sq, n, d, generator=g, device=device).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, n, d, generator=g, device=device).to(dtype)
            for _ in range(2))
    mask = None if kind is None else _key_mask(kind, b, sk, g, device)
    return q, k, v, do, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qshape,sk,causal,kind", _SIGMOID)
def test_sigmoid_attention_kernels(card, qshape, sk, causal, kind, dtype):
    """Forward and backward against the plain versions; rows with no key
    and masked keys are exactly zero, as in the plain version."""
    q, k, v, do, mask = _sigmoid_inputs(qshape, sk, kind, dtype, card,
                                        sum(qshape) + 5 * sk)
    bias = fa.default_logit_bias(sk)
    kw = dict(is_causal=causal, mask=mask, logit_bias=bias)
    before = (fa.sigmoid_launches, fa.sigmoid_bwd_launches, fa.launches,
              fa.bwd_launches)
    o = fa.sigmoid_attention_fwd(q, k, v, **kw)
    got = fa.sigmoid_attention_bwd(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert (fa.sigmoid_launches, fa.sigmoid_bwd_launches, fa.launches,
            fa.bwd_launches) == (before[0] + 1, before[1] + 1, *before[2:])
    assert o.shape == q.shape and o.dtype == dtype
    _close(o, fa.sigmoid_attention_plain(q, k, v, **kw), dtype)
    for a, w in zip(got, fa.sigmoid_attention_bwd_plain(q, k, v, do, **kw)):
        assert a.shape == w.shape and a.dtype == dtype
        scale = max(1.0, w.float().abs().max().item())
        _close(a / scale, w / scale, dtype)
    if mask is not None:
        dead = ~_live(mask, qshape[1], causal)
        assert not o[dead].any()
        assert not got[1][~mask].any() and not got[2][~mask].any()


def test_fp8_and_sigmoid_wrappers_never_take_the_plain_version_on_the_card(
        card, monkeypatch):
    from jimm_tpu_torch.ops import fp8_matmul as fp8

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    for mod, name in ((fp8, "fp8_gemm_plain"),
                      (fa, "sigmoid_attention_plain"),
                      (fa, "sigmoid_attention_bwd_plain")):
        monkeypatch.setattr(mod, name, refuse)
    x = torch.randn(9, 40, device=card, requires_grad=True)
    w = torch.randn(17, 40, device=card, requires_grad=True)
    f0, b0 = fp8.launches, fp8.bwd_launches
    fp8.fp8_matmul(x, w).sum().backward()
    torch.cuda.synchronize()
    assert (fp8.launches, fp8.bwd_launches) == (f0 + 1, b0 + 2)
    # a bf16 Linear: its bias joins the f32 epilogue in f32
    xb, wb = (t.detach().bfloat16().requires_grad_() for t in (x, w))
    bb = torch.zeros(17, device=card, dtype=torch.bfloat16,
                     requires_grad=True)
    fp8.fp8_matmul(xb, wb, bb).sum().backward()
    assert xb.grad.dtype == wb.grad.dtype == bb.grad.dtype == torch.bfloat16
    q, k, v = (torch.randn(2, 9, 2, 16, device=card, requires_grad=True)
               for _ in range(3))
    s0, t0 = fa.sigmoid_launches, fa.sigmoid_bwd_launches
    fa.sigmoid_attention(q, k, v).sum().backward()
    torch.cuda.synchronize()
    assert (fa.sigmoid_launches, fa.sigmoid_bwd_launches) == (s0 + 1, t0 + 1)
    with pytest.raises(ValueError):
        fp8.fp8_gemm(x.detach().to(fp8.E5M2), w.detach().to(fp8.E5M2),
                     torch.ones((), device=card))
    with pytest.raises(ValueError):
        fa.sigmoid_attention(q.double(), k.double(), v.double())


def test_siglip_fp8_hybrid_and_sigmoid_on_the_card(card, monkeypatch):
    """A small SigLIP under fp8_hybrid, and one on sigmoid attention: every
    gradient through the kernels matches the same model on the CPU's plain
    versions. The fp8 step's CPU twin quantizes as the card's step did (a
    one-ulp difference upstream of a quantizer moves an fp8 value by a
    step), and the amax histories after the two steps agree."""
    from jimm_tpu_torch import configs
    from jimm_tpu_torch.models.siglip import SigLIP
    from jimm_tpu_torch.ops import fp8_matmul as fp8
    from jimm_tpu_torch.quant.policy import apply_precision_policy
    from jimm_tpu_torch.train.trainer import contrastive_loss_fn
    cfg = configs.SigLIPConfig(
        vision=configs.VisionConfig(image_size=64, patch_size=16, width=128,
                                    depth=2, num_heads=2, mlp_dim=256,
                                    act="gelu_tanh", pooling="map"),
        text=configs.TextConfig(vocab_size=100, context_length=8, width=128,
                                depth=2, num_heads=2, mlp_dim=256,
                                act="gelu_tanh", causal=False,
                                pooling="last", proj_bias=True),
        projection_dim=128)
    g = torch.Generator(device=card).manual_seed(9)
    images = torch.randn(4, 64, 64, 3, generator=g, device=card)
    text = torch.randint(0, 100, (4, 8), generator=g, device=card)
    for attn_impl, policy in (("flash", "fp8_hybrid"), ("sigmoid", "bf16")):
        rt = configs.with_runtime(cfg, attn_impl=attn_impl, ln_impl="fused")
        kernels = SigLIP(rt, device=card)
        plain = SigLIP(rt, device="cpu")
        plain.load_state_dict({k: v.cpu()
                               for k, v in kernels.state_dict().items()})
        n = apply_precision_policy(kernels, policy)
        apply_precision_policy(plain, policy)
        quantize, tape = fp8.quantize_tensor, []

        def record(x, scale, dtype):
            tape.append(quantize(x, scale, dtype))
            return tape[-1]

        replayed = iter(tape)

        def replay(x, scale, dtype):
            x_q = next(replayed)
            assert x_q.shape == x.shape and x_q.dtype == dtype
            return x_q.to(x.device)

        counts = (fp8.launches, fp8.bwd_launches, fa.sigmoid_launches,
                  fa.sigmoid_bwd_launches)
        monkeypatch.setattr(fp8, "quantize_tensor", record)
        contrastive_loss_fn(kernels, images, text, kind="siglip").backward()
        torch.cuda.synchronize()
        got = (fp8.launches - counts[0], fp8.bwd_launches - counts[1],
               fa.sigmoid_launches - counts[2],
               fa.sigmoid_bwd_launches - counts[3])
        # 2 + 2 blocks x 6 Linears, the MAP head's 6, text_projection; the
        # backward's dx and dw each; 5 attentions
        assert got == ((31, 62, 0, 0) if policy == "fp8_hybrid"
                       else (0, 0, 5, 5)), got
        assert n == (31 if policy == "fp8_hybrid" else 0)
        monkeypatch.setattr(fp8, "quantize_tensor", replay)
        contrastive_loss_fn(plain, images.cpu(), text.cpu(),
                            kind="siglip").backward()
        want = {n: p.grad for n, p in plain.named_parameters()}
        floor = 1e-3 * max(g.abs().max().item() for g in want.values())
        for name, p in kernels.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
            ref = want[name]
            peak = max(ref.abs().max().item(), floor)
            assert (p.grad.cpu() - ref).abs().max().item() <= 1e-3 * peak, name
        bufs = dict(plain.named_buffers())
        for name, buf in kernels.named_buffers():
            torch.testing.assert_close(buf.cpu(), bufs[name], rtol=1e-4,
                                       atol=0)


# -- biased flash (row 5, row 7's bias kind, row 8) ----------------------------

#: (q shape, Sk, causal, bias kind): "full" (N, Sq, Sk), "2d" (Sq, Sk)
#: broadcast over heads (a 0 head stride), "neginf" with -inf entries and a
#: query row with no finite key
_BIAS = [((128, 256, 12, 64), 256, False, "full"),  # SigLIP-B/16 image
         ((32, 1, 12, 64), 256, False, "full"),     # MAP probe
         ((2, 1, 2, 64), 1, False, "full"),
         ((2, 5, 2, 80), 5, True, "full"),
         ((2, 257, 2, 64), 257, True, "full"),
         ((2, 257, 2, 80), 257, False, "2d"),
         ((2, 65, 2, 64), 65, False, "neginf"),
         ((1, 70, 1, 256), 130, True, "full")]


def _bias_inputs(qshape, sk, kind, dtype, device, seed):
    """q, k, v, do in ``dtype``, the f32 (N, Sq, Sk) bias (a broadcast view
    for "2d") and the (B, Sq, N) rows with a finite key."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, sq, n, d = qshape
    q, do = (torch.randn(b, sq, n, d, generator=g, device=device).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, n, d, generator=g, device=device).to(dtype)
            for _ in range(2))
    if kind == "2d":
        bias = torch.randn(sq, sk, generator=g, device=device).expand(n, sq,
                                                                      sk)
    else:
        bias = torch.randn(n, sq, sk, generator=g, device=device)
    if kind == "neginf":
        bias[torch.rand(n, sq, sk, generator=g, device=device) < 0.3] = (
            float("-inf"))
        bias[:, :, 0] = 0.5
        bias[0, min(3, sq - 1)] = float("-inf")
    live = torch.isfinite(bias).any(-1).T[None].expand(b, sq, n)
    return q, k, v, do, bias, live


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qshape,sk,causal,kind", _BIAS)
def test_bias_flash_kernels(card, qshape, sk, causal, kind, dtype):
    """Rows 5, 7-bias and 8 against their plain versions; a row with no
    finite key gives o = 0, lse = -1e30 and zero gradients."""
    q, k, v, do, bias, live = _bias_inputs(qshape, sk, kind, dtype, card,
                                           sum(qshape) + 7 * sk)
    before = (fa.bias_launches, fa.bias_bwd_launches, fa.dbias_launches,
              fa.launches, fa.bwd_launches)
    o, lse = fa.flash_attention_bias_fwd(q, k, v, bias, is_causal=causal)
    want_o, want_lse = fa.flash_attention_bias_plain(q, k, v, bias,
                                                     is_causal=causal)
    got = fa.flash_attention_bias_bwd(q, k, v, bias, want_o, want_lse, do,
                                      is_causal=causal)
    dbias = fa.flash_attention_dbias(q, k, v, bias, want_o, want_lse, do,
                                     is_causal=causal)
    torch.cuda.synchronize()
    assert (fa.bias_launches, fa.bias_bwd_launches, fa.dbias_launches,
            fa.launches, fa.bwd_launches) == (*(c + 1 for c in before[:3]),
                                              *before[3:])
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    _close(o[live], want_o[live], dtype)
    _close(lse.transpose(1, 2)[live], want_lse.transpose(1, 2)[live],
           torch.float32)
    assert not o[~live].any() and (lse.transpose(1, 2)[~live] == -1e30).all()
    want = fa.flash_attention_bias_bwd_plain(q, k, v, bias, want_o,
                                             want_lse, do, is_causal=causal)
    want_dbias = fa.flash_attention_dbias_plain(q, k, v, bias, want_o,
                                                want_lse, do,
                                                is_causal=causal)
    for a, w in zip((*got, dbias), (*want, want_dbias)):
        assert a.shape == w.shape and a.dtype == w.dtype
        scale = max(1.0, w.float().abs().max().item())
        _close(a / scale, w / scale, dtype if a.dtype == dtype
               else torch.float32)
    assert not dbias[torch.isinf(bias)].any()


def test_bias_path_runs_the_kernels_and_routes_as_jax(card, monkeypatch):
    """``dot_product_attention(..., bias=)`` under "auto" on the card runs
    rows 5, 7-bias and 8 (never their plain versions), its gradient reaches
    the caller's (Sq, Sk) bias; a 4-D bias or a bias with a mask goes to the
    einsum path, and no bias kernel launches."""
    from jimm_tpu_torch.ops import attention

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    for name in ("flash_attention_bias_plain",
                 "flash_attention_bias_bwd_plain",
                 "flash_attention_dbias_plain"):
        monkeypatch.setattr(fa, name, refuse)
    q, k, v = (torch.randn(2, 9, 2, 16, device=card, requires_grad=True)
               for _ in range(3))
    bias = torch.randn(9, 9, device=card, requires_grad=True)

    def counts():
        return fa.bias_launches, fa.bias_bwd_launches, fa.dbias_launches

    c0 = counts()
    attention.dot_product_attention(q, k, v, bias=bias).sum().backward()
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in c0)
    assert bias.grad.shape == (9, 9)
    # the key-padding mask as the NaFlex tower builds it: the einsum path
    # takes masks broadcastable to (B, N, Sq, Sk)
    mask = torch.ones(2, 1, 1, 9, dtype=torch.bool, device=card)
    c0 = counts()
    attention.dot_product_attention(q, k, v, bias=bias[None, None])
    attention.dot_product_attention(q, k, v, bias=bias, mask=mask)
    assert counts() == c0
    with pytest.raises(ValueError, match="flash_masked does not take a bias"):
        attention.dot_product_attention(q, k, v, bias=bias, mask=mask,
                                        impl="flash")


# -- the tensor-core bodies of rows 7 (every kind) and 9 at odd shapes -------

#: (q shape, Sk, causal, q an unaligned strided view): the odd shapes
#: chip_smoke.py's phase 3 adds for the bf16 mma.sync bodies, and D = 256,
#: where bf16 keeps the flash backward's FMA body
_TENSOR_CORE_ODD = [((2, 5, 2, 64), 5, False, False),
                    ((2, 257, 2, 80), 257, True, False),
                    ((2, 257, 2, 64), 257, False, True),
                    ((2, 5, 2, 80), 5, True, True),
                    ((2, 1, 2, 64), 257, False, False),
                    ((1, 70, 1, 256), 130, True, False)]


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """The same (B, S, N, D) values as a view whose base and head stride
    are off any 16-byte boundary, unit stride over D."""
    b, s, n, d = x.shape
    store = torch.zeros(b, s, n, d + 3, dtype=x.dtype, device=x.device)
    store[..., 1:d + 1] = x
    return store[..., 1:d + 1]


def _close_scaled(got, want, dtype=torch.bfloat16) -> None:
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        scale = max(1.0, w.float().abs().max().item())
        _close(a / scale, w / scale, dtype)


@pytest.mark.parametrize("kind", ["softmax", "mask", "sigmoid", "bias"])
@pytest.mark.parametrize("qshape,sk,causal,view", _TENSOR_CORE_ODD)
def test_flash_backward_tensor_core_body(card, kind, qshape, sk, causal,
                                         view):
    """Row 7 in bf16 (dq and dk/dv on mma.sync up to D = 128) against its
    plain version in each kind; masked keys get exactly zero dk and dv."""
    dtype = torch.bfloat16
    b, sq, n, d = qshape
    if kind == "bias":
        q, k, v, do, bias, _ = _bias_inputs(qshape, sk, "full", dtype, card,
                                            sum(qshape) + 11 * sk)
    else:
        q, k, v, do, mask = _sigmoid_inputs(
            qshape, sk, "sparse" if kind == "mask" else None, dtype, card,
            sum(qshape) + 13 * sk)
    if view:
        q = _unaligned(q)
    if kind == "bias":
        o, lse = fa.flash_attention_bias_plain(q, k, v, bias,
                                               is_causal=causal)
        got = fa.flash_attention_bias_bwd(q, k, v, bias, o, lse, do,
                                          is_causal=causal)
        want = fa.flash_attention_bias_bwd_plain(q, k, v, bias, o, lse, do,
                                                 is_causal=causal)
    elif kind == "sigmoid":
        kw = dict(is_causal=causal, logit_bias=fa.default_logit_bias(sk))
        got = fa.sigmoid_attention_bwd(q, k, v, do, **kw)
        want = fa.sigmoid_attention_bwd_plain(q, k, v, do, **kw)
    else:
        if mask is not None:  # no cotangent on rows with no key
            do = do * _live(mask, sq, causal)[:, :, None, None].to(dtype)
        o, lse = fa.flash_attention_plain(q, k, v, is_causal=causal,
                                          mask=mask)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, is_causal=causal,
                                     mask=mask)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            is_causal=causal, mask=mask)
    torch.cuda.synchronize()
    _close_scaled(got, want)
    if kind == "mask":
        assert not got[1][~mask].any() and not got[2][~mask].any()


@pytest.mark.parametrize("qshape,sk,causal,kind", [
    ((2, 256, 2, 64), 256, False, "2d"),       # a broadcast (256, 256) bias
    ((2, 257, 2, 80), 257, True, "neginf"),    # -inf keys, a row with none
    ((2, 65, 2, 64), 65, False, "neginf")])
def test_flash_bias_backward_tensor_core_body(card, qshape, sk, causal, kind):
    """Row 7's bias kind in bf16 with a broadcast bias (read through a 0
    head stride, staged by cp.async in dk/dv) and with -inf entries."""
    q, k, v, do, bias, _ = _bias_inputs(qshape, sk, kind, torch.bfloat16,
                                        card, sum(qshape) + 17 * sk)
    o, lse = fa.flash_attention_bias_plain(q, k, v, bias, is_causal=causal)
    got = fa.flash_attention_bias_bwd(q, k, v, bias, o, lse, do,
                                      is_causal=causal)
    torch.cuda.synchronize()
    _close_scaled(got, fa.flash_attention_bias_bwd_plain(
        q, k, v, bias, o, lse, do, is_causal=causal))


@pytest.mark.parametrize("qshape,sk,causal,view", _TENSOR_CORE_ODD + [
    ((2, 65, 2, 30), 65, False, False)])        # D not a multiple of 16
def test_flash_int8_tensor_core_body(card, qshape, sk, causal, view):
    """Row 9 in bf16 (scores on s8 mma.sync, P.V on bf16 mma.sync) against
    its plain version; ``view``: int8 q and k 4 bytes past a 16-byte
    boundary and v an unaligned strided view (the element-by-element
    loads)."""
    from jimm_tpu_torch.ops import flash_attention_int8 as fa8
    qq, qs, kq, ks, v, _ = _int8_flash_inputs(qshape, sk, torch.bfloat16,
                                              card, sum(qshape) + 19 * sk)
    if view:
        def shifted(x):
            flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
            flat[4:] = x.flatten()
            return flat[4:].view(x.shape)
        qq, kq, v = shifted(qq), shifted(kq), _unaligned(v)
    before = fa8.launches
    o, lse = fa8.flash_attention_int8_fwd(qq, qs, kq, ks, v,
                                          is_causal=causal)
    torch.cuda.synchronize()
    assert fa8.launches == before + 1
    want_o, want_lse = fa8.flash_attention_int8_plain(qq, qs, kq, ks, v,
                                                      is_causal=causal)
    _close(o, want_o, torch.bfloat16)
    _close(lse, want_lse, torch.float32)


# -- the tensor-core bodies of rows 10 and 8 at odd shapes ------------------

def _shifted(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose base is 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    flat[4:] = x.flatten()
    return flat[4:].view(x.shape)


@pytest.mark.parametrize("qshape,sk,causal,view", _TENSOR_CORE_ODD + [
    ((2, 65, 2, 30), 65, False, True)])         # D not a multiple of 16
def test_flash_int8_backward_tensor_core_body(card, qshape, sk, causal,
                                              view):
    """Row 10 in bf16 (scores on s8 mma.sync, dp and the gradients on bf16
    mma.sync, D = 256 on the FMA body) against its plain version; ``view``:
    int8 q and k 4 bytes past a 16-byte boundary, v and do unaligned
    strided views (the element-by-element loads)."""
    from jimm_tpu_torch.ops import flash_attention_int8 as fa8
    qq, qs, kq, ks, v, do = _int8_flash_inputs(qshape, sk, torch.bfloat16,
                                               card, sum(qshape) + 23 * sk)
    if view:
        qq, kq = _shifted(qq), _shifted(kq)
        v, do = _unaligned(v), _unaligned(do)
    o, lse = fa8.flash_attention_int8_plain(qq, qs, kq, ks, v,
                                            is_causal=causal)
    before = fa8.bwd_launches
    got = fa8.flash_attention_int8_bwd(qq, qs, kq, ks, v, o, lse, do,
                                       is_causal=causal)
    torch.cuda.synchronize()
    assert fa8.bwd_launches == before + 1
    want = fa8.flash_attention_int8_bwd_plain(qq, qs, kq, ks, v, o, lse, do,
                                              is_causal=causal)
    for a, w in zip(got, want):
        if w.float().abs().max().item() <= 1e-6:
            # one key: dq = dk = 0 up to rounding on both sides
            assert (a.float() - w.float()).abs().max().item() <= 1e-5
        else:
            _close_scaled((a,), (w,))


#: (q shape, Sk, causal, bias kind, q an unaligned strided view)
_DBIAS_ODD = [((2, 256, 2, 64), 256, False, "2d", False),
              ((2, 257, 2, 80), 257, True, "neginf", False),
              ((2, 5, 2, 64), 5, False, "full", False),
              ((2, 257, 2, 64), 257, False, "full", True),
              ((24, 256, 2, 64), 256, False, "neginf", False),
              ((1, 70, 1, 256), 130, True, "full", False)]


@pytest.mark.parametrize("qshape,sk,causal,kind,view", _DBIAS_ODD)
def test_dbias_tensor_core_body(card, qshape, sk, causal, kind, view):
    """Row 8 in bf16 (s and dp on mma.sync up to D = 128, D = 256 on the
    FMA body) against its plain version at f32's tolerance of its scale;
    -inf entries get exactly zero; (24, 256, 2, 64) sums its batch in 8
    ranges of 3."""
    q, k, v, do, bias, _ = _bias_inputs(qshape, sk, kind, torch.bfloat16,
                                        card, sum(qshape) + 29 * sk)
    if view:
        q = _unaligned(q)
    o, lse = fa.flash_attention_bias_plain(q, k, v, bias, is_causal=causal)
    before = fa.dbias_launches
    got = fa.flash_attention_dbias(q, k, v, bias, o, lse, do,
                                   is_causal=causal)
    torch.cuda.synchronize()
    assert fa.dbias_launches == before + 1
    want = fa.flash_attention_dbias_plain(q, k, v, bias, o, lse, do,
                                          is_causal=causal)
    scale = max(1.0, want.abs().max().item())
    _close(got / scale, want / scale, torch.float32)
    assert not got[torch.isinf(bias)].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dbias_is_the_same_in_every_run(card, dtype):
    """The batch ranges are summed in order by a second kernel, with no
    atomics: two runs give the same bits, at the train shape (4 ranges)
    and at one that splits into 8 ranges."""
    for qshape, sk in (((128, 256, 12, 64), 256), ((24, 256, 2, 64), 256)):
        q, k, v, do, bias, _ = _bias_inputs(qshape, sk, "full", dtype, card,
                                            sum(qshape))
        o, lse = fa.flash_attention_bias_plain(q, k, v, bias)
        runs = [fa.flash_attention_dbias(q, k, v, bias, o, lse, do)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])
