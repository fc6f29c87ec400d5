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
        cos = torch.nn.functional.cosine_similarity(got, want, dim=0)
        assert cos.item() >= 0.999
        peak = want.abs().max().item()
        assert (got - want).abs().max().item() <= 2.0**-7 * peak + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,f", [(1, 64), (7, 80), (300, 768),
                                    (8192, 768), (3, 5000)])
def test_layer_norm_kernel(card, rows, f, dtype):
    g = torch.Generator(device=card).manual_seed(rows + f)
    x = (torch.randn(rows, f, generator=g, device=card) * 3 + 0.5).to(dtype)
    w = torch.randn(f, generator=g, device=card).to(dtype)
    b = torch.randn(f, generator=g, device=card).to(dtype)
    before = ln.launches
    y, mu, rstd = ln.layer_norm_fwd(x, w, b, 1e-6)
    torch.cuda.synchronize()
    assert ln.launches == before + 1
    want_y, want_mu, want_rstd = ln.layer_norm_plain(x, w, b, 1e-6)
    assert y.dtype == dtype and mu.dtype == rstd.dtype == torch.float32
    _close(y, want_y, dtype)
    _close(mu, want_mu, torch.float32)
    torch.testing.assert_close(rstd, want_rstd, atol=1e-4, rtol=1e-4)


_FLASH = [((32, 256, 12, 64), 256, False),   # image self-attention
          ((32, 1, 12, 64), 256, False),     # MAP probe
          ((32, 64, 12, 64), 64, False),     # text self-attention
          ((2, 5, 2, 80), 5, True), ((2, 257, 2, 64), 257, True),
          ((2, 1, 2, 32), 257, False), ((2, 257, 2, 80), 257, False),
          ((1, 70, 1, 256), 130, True)]


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
                                    (32768, 768), (3, 5000)])
def test_layer_norm_backward_kernel(card, rows, f, dtype):
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
