"""The port's checkpoint IO (`jimm_tpu_torch/weights/`) against the JAX
package's: safetensors read and write for every dtype (bit patterns; the
files both packages write are byte-identical), checkpoint resolution over
every local layout, a hub name without huggingface_hub, position-table
interpolation, and the mapping engine's four strictness errors on the same
malformed checkpoint."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from flax import nnx

from hf_util import save_tiny_vit
from jimm_tpu import configs as jax_configs
from jimm_tpu.models.vit import VisionTransformer as JaxViT
from jimm_tpu.weights import loader as jax_loader
from jimm_tpu.weights import resolve as jax_resolve
from jimm_tpu.weights import safetensors_io as jax_st
from jimm_tpu.weights import surgery as jax_surgery
from jimm_tpu_torch import configs
from jimm_tpu_torch.models.vit import VisionTransformer
from jimm_tpu_torch.weights import loader, resolve, surgery
from jimm_tpu_torch.weights import safetensors_io as st


def _bits(a) -> np.ndarray:
    """A tensor's or array's bytes as unsigned integers of its width."""
    if isinstance(a, torch.Tensor):
        a = a.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[a.element_size()]).numpy()
    return np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")


def _sample(name: str, shape=(3, 5)) -> np.ndarray:
    """Random bytes of dtype ``name`` as the JAX package holds them (every
    bit pattern, NaNs included, for the float formats)."""
    dt = jax_st._DTYPES[name]
    rng = np.random.default_rng(len(name))
    if dt == np.bool_:
        return rng.integers(0, 2, shape).astype(np.bool_)
    raw = rng.integers(0, 256, shape + (dt.itemsize,), dtype=np.uint8)
    return raw.view(dt).reshape(shape)


@pytest.mark.parametrize("name", sorted(jax_st._DTYPES))
def test_safetensors_dtype_round_trip(name, tmp_path):
    """JAX writes, the port reads; the port writes the same file byte for
    byte, and JAX reads it back."""
    arrays = {"t": _sample(name), "scalar": _sample(name, ())}
    jax_st.save_file(arrays, tmp_path / "jax.safetensors",
                     metadata={"format": "pt"})
    got = st.load_file(tmp_path / "jax.safetensors")
    assert got["t"].dtype == st._DTYPES[name]
    for key, arr in arrays.items():
        # the JAX writer stores a 0-d array as (1,)
        assert tuple(got[key].shape) == (arr.shape or (1,))
        np.testing.assert_array_equal(_bits(got[key]).reshape(arr.shape),
                                      _bits(arr))
    st.save_file(got, tmp_path / "port.safetensors", metadata={"format": "pt"})
    assert ((tmp_path / "port.safetensors").read_bytes()
            == (tmp_path / "jax.safetensors").read_bytes())
    back = jax_st.load_file(tmp_path / "port.safetensors")
    for key, arr in arrays.items():
        np.testing.assert_array_equal(_bits(back[key]).reshape(arr.shape),
                                      _bits(arr))
    # a 0-d tensor of the port's own is written as JAX writes a 0-d array
    st.save_file({"s": got["scalar"].reshape(())}, tmp_path / "p0.safetensors")
    jax_st.save_file({"s": arrays["scalar"]}, tmp_path / "j0.safetensors")
    assert ((tmp_path / "p0.safetensors").read_bytes()
            == (tmp_path / "j0.safetensors").read_bytes())


def test_safetensors_files_are_byte_identical(tmp_path):
    """Every dtype in one file, both packages writing it from their own
    tensors (torch from numpy; bf16 and fp8 through their bit patterns),
    without and with metadata; the port's header alike."""
    arrays = {name: _sample(name, (2, 3)) for name in jax_st._DTYPES}
    tensors = {name: st.load_file(_one(tmp_path, name, arr))[name]
               for name, arr in arrays.items()}
    for metadata in (None, {"format": "pt", "note": "x"}):
        jax_st.save_file(arrays, tmp_path / "jax.safetensors", metadata)
        st.save_file(tensors, tmp_path / "port.safetensors", metadata)
        assert ((tmp_path / "port.safetensors").read_bytes()
                == (tmp_path / "jax.safetensors").read_bytes())
        assert (st.read_header(tmp_path / "port.safetensors")
                == jax_st.read_header(tmp_path / "jax.safetensors"))
    # the header is padded to 8 bytes, and loaded tensors are writable
    # without touching the file
    _, start = st.read_header(tmp_path / "port.safetensors")
    assert start % 8 == 0
    before = (tmp_path / "port.safetensors").read_bytes()
    st.load_file(tmp_path / "port.safetensors")["F32"].fill_(7.0)
    assert (tmp_path / "port.safetensors").read_bytes() == before


def _one(tmp_path, name, arr):
    path = tmp_path / f"one_{name}.safetensors"
    jax_st.save_file({name: arr}, path)
    return path


def test_unsupported_dtype_is_refused(tmp_path):
    with pytest.raises(ValueError, match="unsupported dtype"):
        st.save_file({"c": torch.zeros(2, dtype=torch.complex64)},
                     tmp_path / "x.safetensors")


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """One small state dict written in every local layout the resolver
    reads: ``{layout: (path, use_pytorch)}``."""
    root = tmp_path_factory.mktemp("layouts")
    rng = np.random.default_rng(0)
    state = {"a.weight": rng.standard_normal((4, 3), np.float32),
             "b.bias": rng.standard_normal((5,), np.float32),
             "c.position_ids": np.arange(6, dtype=np.int64)}
    config = {"model_type": "toy", "hidden_size": 3}

    def directory(name, with_config=True):
        d = root / name
        d.mkdir(parents=True)
        if with_config:
            (d / "config.json").write_text(json.dumps(config))
        return d

    def torch_save(obj, path):
        torch.save({k: torch.from_numpy(v) for k, v in obj.items()}, path)

    out = {}
    d = directory("single")
    jax_st.save_file(state, d / "model.safetensors")
    out["dir"] = (d, False)
    out["file"] = (d / "model.safetensors", False)
    d = directory("sharded")
    keys = sorted(state)
    shards = {"model-00001-of-00002.safetensors": keys[:2],
              "model-00002-of-00002.safetensors": keys[2:]}
    for shard, names in shards.items():
        jax_st.save_file({k: state[k] for k in names}, d / shard)
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: s for s, names in shards.items() for k in names}}))
    out["sharded"] = (d, False)
    d = directory("glob")
    jax_st.save_file({k: state[k] for k in keys[:1]}, d / "x.safetensors")
    jax_st.save_file({k: state[k] for k in keys[1:]}, d / "y.safetensors")
    out["glob"] = (d, False)
    d = directory("bin")
    torch_save(state, d / "pytorch_model.bin")
    out["bin_fallback"] = (d, False)
    d = directory("both")
    jax_st.save_file({k: v * 2 for k, v in state.items()},
                     d / "model.safetensors")
    torch_save(state, d / "pytorch_model.bin")
    out["use_pytorch"] = (d, True)
    d = directory("parent") / "model"
    d.mkdir()
    jax_st.save_file(state, d / "weights.safetensors")
    out["model_parent"] = (d / "weights.safetensors", False)
    return out


@pytest.mark.parametrize("layout", ["dir", "file", "sharded", "glob",
                                    "bin_fallback", "use_pytorch",
                                    "model_parent"])
def test_resolve_matches_jax(layouts, layout):
    path, use_pytorch = layouts[layout]
    want_w, want_cfg = jax_resolve.resolve_checkpoint(
        str(path), use_pytorch=use_pytorch)
    got_w, got_cfg = resolve.resolve_checkpoint(path, use_pytorch=use_pytorch)
    assert got_cfg == want_cfg and got_cfg["model_type"] == "toy"
    assert sorted(got_w) == sorted(want_w)
    for key, arr in want_w.items():
        assert isinstance(got_w[key], torch.Tensor)
        np.testing.assert_array_equal(got_w[key].numpy(), arr)


def test_resolve_refusals(tmp_path, monkeypatch):
    # a hub name without huggingface_hub: both packages' error (the hub
    # path itself is held to JAX's in test_torch_hub_retry.py)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(FileNotFoundError) as want:
        jax_resolve.resolve_checkpoint("google/vit-base-patch16-224")
    with pytest.raises(FileNotFoundError) as got:
        resolve.resolve_checkpoint("google/vit-base-patch16-224")
    assert str(got.value) == str(want.value)
    for missing in ("./nope", str(tmp_path / "nope"), "a/b/c"):
        with pytest.raises(FileNotFoundError):
            resolve.resolve_checkpoint(missing)
        with pytest.raises(FileNotFoundError):
            jax_resolve.resolve_checkpoint(missing)
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        resolve.resolve_checkpoint(tmp_path, use_pytorch=True)
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        resolve.resolve_checkpoint(tmp_path)


@pytest.mark.parametrize("n_prefix,rank,old,new", [
    (0, 2, 4, 6), (1, 3, 4, 6), (1, 2, 7, 3), (0, 3, 5, 5)])
def test_interpolate_pos_embed_matches_jax(n_prefix, rank, old, new):
    rng = np.random.default_rng(n_prefix * 10 + old)
    pos = rng.standard_normal((n_prefix + old * old, 8)).astype(np.float32)
    if rank == 3:
        pos = pos[None]
    want = jax_surgery.interpolate_pos_embed(pos, new, n_prefix=n_prefix)
    got = surgery.interpolate_pos_embed(torch.from_numpy(pos), new,
                                        n_prefix=n_prefix)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # bf16 tables keep their dtype and their class-token rows exactly
    half = surgery.interpolate_pos_embed(
        torch.from_numpy(pos).to(torch.bfloat16), new, n_prefix=n_prefix)
    assert half.dtype == torch.bfloat16
    lead = (slice(None),) * (rank - 2) + (slice(0, n_prefix),)
    assert torch.equal(half[lead],
                       torch.from_numpy(pos).to(torch.bfloat16)[lead])


# -- the mapping engine's strictness -----------------------------------------

@pytest.fixture(scope="module")
def vit_checkpoint(tmp_path_factory):
    """A tiny HF ViT checkpoint, its weights as read by each package, the
    config, and one model of each package built from it."""
    path = save_tiny_vit(tmp_path_factory.mktemp("vit_strict"))
    jw, config = jax_resolve.resolve_checkpoint(path)
    tw, _ = resolve.resolve_checkpoint(path)
    jcfg = JaxViT.config_from_hf(config, jw)
    jmodel = JaxViT(jcfg, rngs=nnx.Rngs(0))
    tcfg = VisionTransformer.config_from_hf(config, tw)
    tmodel = VisionTransformer(tcfg, device="cpu")
    return path, jmodel, tmodel


def _malformed(weights: dict, fault: str) -> dict:
    w = dict(weights)
    if fault == "missing":
        del w["vit.layernorm.bias"]
    elif fault == "unused":
        w["bogus.tensor"] = w["vit.layernorm.bias"]
    elif fault == "shape":
        w["vit.layernorm.bias"] = w["vit.layernorm.bias"][:-1]
    return w


@pytest.mark.parametrize("fault,message", [
    ("missing", "checkpoint missing tensor 'vit.layernorm.bias'"),
    ("unused", r"unused checkpoint tensors: \['bogus.tensor'\]"),
    ("shape", "shape mismatch for .*ln_post.*bias"),
    ("double", "assigned twice")])
def test_strictness_errors_match_jax(vit_checkpoint, tmp_path, fault,
                                     message):
    """Each fault in the same malformed file (written once, read by each
    package) raises MappingError in both packages; the double assignment
    comes from a mapping that names one parameter twice, on the intact
    file."""
    path, jmodel, tmodel = vit_checkpoint
    d = tmp_path / "bad"
    d.mkdir()
    weights = st.load_file(os.path.join(path, "model.safetensors"))
    st.save_file(_malformed(weights, fault), d / "model.safetensors")
    shutil.copy(os.path.join(path, "config.json"), d)
    jw, _ = jax_resolve.resolve_checkpoint(str(d))
    tw, _ = resolve.resolve_checkpoint(d)
    jmap = JaxViT.hf_mapping(jmodel.config)
    tmap = VisionTransformer.hf_mapping(tmodel.config)
    if fault == "double":
        jmap = jmap + [jax_loader.M("classifier.bias", "classifier.bias")]
        tmap = tmap + [loader.M("classifier.bias", "classifier.bias")]
    with pytest.raises(jax_loader.MappingError, match=message):
        jax_loader.apply_mapping(jmodel, jw, jmap,
                                 num_layers=jmodel.config.vision.depth)
    with pytest.raises(loader.MappingError, match=message):
        loader.apply_mapping(tmodel, tw, tmap)


def test_failed_mapping_writes_nothing(vit_checkpoint):
    _, _, tmodel = vit_checkpoint
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    weights, _ = resolve.resolve_checkpoint(vit_checkpoint[0])
    with pytest.raises(loader.MappingError, match="unused"):
        loader.apply_mapping(tmodel, _malformed(weights, "unused"),
                             VisionTransformer.hf_mapping(tmodel.config))
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_transforms_invert():
    rng = torch.Generator().manual_seed(0)
    w = torch.randn(6, 48, generator=rng)  # a NaFlex (D, p*p*3), p = 4
    conv = loader.T.patch(w)
    assert tuple(conv.shape) == (6, 3, 4, 4)
    # (row, col, chan) input order: the JAX package's HWIO kernel is this
    # weight permuted
    hwio = jax_loader.T.patch(w.numpy())
    np.testing.assert_array_equal(conv.permute(2, 3, 1, 0).numpy(), hwio)
    fused = torch.randn(9, 4, generator=rng)
    parts = [loader.T.chunk(3, i)(fused) for i in range(3)]
    assert torch.equal(torch.cat(parts), fused)
    for t, shape in [(loader.T.scalar_1d, (1,)), (loader.T.scalar, ()),
                     (loader.T.unsqueeze, (5, 2)),
                     (loader.T.reshape_1_1_d, (7,))]:
        x = torch.randn(shape, generator=rng)
        assert torch.equal(t.inv(t(x)), x)
    entries = loader.per_layer([loader.M("b.{i}.w", "l.{i}.w"),
                                loader.M("x", "y")], 2)
    assert [(e.dst, e.src) for e in entries] == [
        ("b.0.w", "l.0.w"), ("b.1.w", "l.1.w"), ("x", "y")]
    for act in ("gelu", "gelu_tanh", "quick_gelu", "relu"):
        assert configs.act_to_hf(act) == jax_configs.act_to_hf(act)
