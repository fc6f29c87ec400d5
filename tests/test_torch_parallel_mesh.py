"""The port's mesh and sharding rules (``jimm_tpu_torch/parallel/mesh.py``,
``sharding.py``, ``seqpar.py``'s planner) against the JAX package's, with
no process group: the mesh sizes (the ``-1`` axis, products, refusals),
the nine presets and the topologies as data, ``prune_spec`` and
``resolve_logical_spec``, every parameter's resolved spec under every
preset (the port's table of logical names against the JAX modules'
``logical(...)`` annotations), the seq-parallel planner and byte counts,
the transport probe (two gloo CPU ranks, two of its cases), the slices the
``model`` axis cuts under the tp presets (none under ``pp``), the train
command's rules (JAX's eight choices) and its refusals, with JAX's
messages: ``--max-devices`` out of range or short of the mesh, and the
pipeline flags' and configs'."""

import dataclasses
import json

import jax
import numpy as np
import pytest
from flax import nnx
from jax.sharding import Mesh, PartitionSpec as P

from jimm_tpu import cli as jax_cli
from jimm_tpu import preset as jax_preset
from jimm_tpu.parallel import mesh as jax_mesh
from jimm_tpu.parallel import seqpar as jax_seqpar
from jimm_tpu.parallel import sharding as jax_sharding
from jimm_tpu_torch import cli
from jimm_tpu_torch.configs import preset
from jimm_tpu_torch.models.common import _port_entries
from jimm_tpu_torch.parallel import mesh, seqpar, sharding

SIZES = {"replica": 1, "data": 2, "model": 2, "seq": 2, "stage": 1}


@pytest.mark.parametrize("axes,n,want", [
    ({"data": -1}, 8, {"data": 8}),
    ({"data": 2, "seq": -1}, 8, {"data": 2, "seq": 4}),
    ({"replica": 2, "data": 2, "seq": 2}, 8,
     {"replica": 2, "data": 2, "seq": 2}),
])
def test_mesh_sizes_resolve_like_jax(axes, n, want):
    assert mesh.mesh_sizes(axes, n) == want
    got = jax_mesh.make_mesh(axes, devices=jax.devices()[:n])
    assert dict(got.shape) == want


@pytest.mark.parametrize("axes,n,match", [
    ({"data": -1, "seq": -1}, 4, "at most one axis may be -1"),
    ({"data": 3, "seq": -1}, 4, "4 devices not divisible by 3"),
    ({"data": 2}, 4, r"mesh \{'data': 2\} != 4 devices"),
    ({"dat": 4}, 4, "unknown mesh axis 'dat'"),
])
def test_mesh_sizes_refuse(axes, n, match):
    with pytest.raises(ValueError, match=match):
        mesh.mesh_sizes(axes, n)


def test_presets_and_topologies_are_jax_data():
    assert sorted(sharding.PRESET_RULES) == sorted(jax_sharding.PRESET_RULES)
    for name, rules in sharding.PRESET_RULES.items():
        assert dataclasses.asdict(rules) == dataclasses.asdict(
            jax_sharding.PRESET_RULES[name]), name
    assert mesh.TOPOLOGIES == jax_mesh.TOPOLOGIES
    assert mesh.MESH_AXES == jax_mesh.MESH_AXES


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (4, 6)), (("data", None), (3, 8)),
    ((("replica", "data"), "seq"), (4, 7)), (("model",), (2, 2, 2)),
])
def test_prune_spec_matches_jax(spec, shape):
    jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(
        tuple(SIZES.values())), tuple(SIZES))
    want = jax_sharding.prune_spec(P(*spec), shape, jmesh)
    assert sharding.prune_spec(spec, shape, SIZES) == tuple(want)


@pytest.mark.parametrize("rules", sorted(sharding.PRESET_RULES))
def test_resolve_logical_spec_matches_jax(rules):
    spec = ("batch", "seq", ("embed", "heads"), None, "vocab", "pos")
    want = jax_sharding.resolve_logical_spec(
        P(*spec), jax_sharding.PRESET_RULES[rules])
    got = sharding.resolve_logical_spec(spec, sharding.PRESET_RULES[rules])
    assert got == tuple(want)


def _jax_specs(model, rules, jmesh) -> dict[str, tuple]:
    """Each JAX parameter's resolved, pruned spec in the port's dimension
    order, by port parameter name."""
    state = nnx.state(model, nnx.Param)
    specs = dict(nnx.to_flat_state(nnx.get_partition_spec(state)))
    out = {}
    for path, var in nnx.to_flat_state(state):
        key = ".".join(str(p) for p in path)
        val = var[...]
        s = specs[path]
        s = s.get_value() if isinstance(s, nnx.Variable) else s
        s = s if isinstance(s, P) else P()
        s = tuple(jax_sharding.prune_spec(
            jax_sharding.resolve_logical_spec(s, rules), val.shape, jmesh))
        s = s + (None,) * (val.ndim - len(s))
        parts = key.split(".")
        if "blocks" in parts:
            s = s[1:]  # the stacked layer axis
        if parts[-1] == "kernel":
            s = ((s[3], s[2], s[0], s[1]) if parts[-2] == "conv"
                 else s[:-2] + (s[-1], s[-2]))
        for name, _ in _port_entries(key, np.empty(val.shape)):
            out[name] = s
    return out


@pytest.mark.parametrize("name", ["siglip-base-patch16-256",
                                  "clip-vit-base-patch16",
                                  "vit-base-patch16-224"])
def test_parameter_specs_match_jax_under_every_preset(name):
    fam = cli.family(name)
    jmodel = jax_cli._model_cls(fam)(jax_cli._tiny_override(
        jax_preset(name)), rngs=nnx.Rngs(0))
    model = cli.MODELS[fam](cli.tiny_override(preset(name)), device="cpu")
    jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(
        tuple(SIZES.values())), tuple(SIZES))
    for rname, rules in sharding.PRESET_RULES.items():
        want = _jax_specs(jmodel, jax_sharding.PRESET_RULES[rname], jmesh)
        got = sharding.partition_specs(model, SIZES, rules)
        assert got == want, rname


@pytest.mark.parametrize("heads,p,plan", [(12, 2, "auto"), (12, 4, "auto"),
                                          (6, 4, "auto"), (12, 4, "ring"),
                                          (12, 2, "ulysses")])
def test_seq_parallel_planner_matches_jax(heads, p, plan):
    assert seqpar.plan_seq_parallel(heads, p, plan=plan) == \
        jax_seqpar.plan_seq_parallel(heads, p, plan=plan)
    for kw in ({"plan": "ring"}, {"plan": "ring", "masked": True},
               {"plan": "ulysses"}):
        assert seqpar.seqpar_comm_bytes(64, 256, heads, 64, p, **kw) == \
            jax_seqpar.seqpar_comm_bytes(64, 256, heads, 64, p, **kw)


@pytest.mark.parametrize("rules", sharding.MODEL_STAGE_RULES)
def test_part_2_rules_are_refused(rules):
    # once refused, now laid out: the dimension of each parameter a model
    # rank holds a slice of, from the table of logical names on the whole
    # model (no parameter is cut over 'stage': a stage keeps whole blocks)
    name = "siglip-base-patch16-256"
    model = cli.MODELS["siglip"](cli.tiny_override(preset(name)),
                                 device="cpu")
    dims = {n: sharding._model_dim(s) for n, s in
            sharding.partition_specs(model, SIZES, rules).items()}
    block = "vision.encoder.blocks.0."
    want = {f"{block}attn.q.weight": 0, f"{block}attn.q.bias": 0,
            f"{block}attn.out.weight": 1, f"{block}attn.out.bias": None,
            f"{block}mlp.fc1.weight": 0, f"{block}mlp.fc2.weight": 1,
            f"{block}mlp.fc2.bias": None, f"{block}ln1.weight": None,
            "vision.head.attn.k.weight": 0, "vision.head.probe": None,
            "vision.patch_embed.conv.weight": None,
            "text.token_embed.weight": 0, "text_projection.weight": 0,
            "text_projection.bias": 0, "logit_scale": None}
    if rules == "pp":
        want = dict.fromkeys(want)
    assert {n: dims[n] for n in want} == want
    assert "stage" not in str(sharding.partition_specs(model, SIZES, rules))


def test_train_rules_are_the_jax_clis():
    def choices(parser):
        sub = next(a for a in parser._actions if a.choices and "train" in
                   a.choices).choices["train"]
        return next(a for a in sub._actions if a.dest == "rules").choices
    assert sorted(choices(cli.build_parser())) == sorted(
        choices(jax_cli.build_parser()))
    assert "hybrid_fsdp_tp" in sharding.PRESET_RULES


@pytest.mark.parametrize("argv,match", [
    # the cases that refused parts 2 and 3 of the parallelism item now
    # check the JAX CLI's errors: --max-devices out of range or short of
    # the mesh, and the pipeline flags' and configs'
    pytest.param(["--mesh", "data=1,model=2", "--rules", "tp", "--precision",
                  "fp8_hybrid", "--max-devices", "3"],
                 r"--max-devices 3 out of range \(1\.\.2 visible\)",
                 id="argv0---rules tp .*item 6 part 2"),
    pytest.param(["--mesh", "data=1,stage=2", "--rules", "pp", "--precision",
                  "int8_qk", "--max-devices", "1"],
                 r"mesh \{'data': 1, 'stage': 2\} != 1 devices",
                 id="argv1---rules pp .*item 6 part 2"),
    pytest.param(["--pipeline-microbatches", "2"],
                 r"--pipeline-microbatches needs --rules pp \(layers",
                 id="argv2-item 6 part 2"),
    pytest.param(["--pipeline-virtual", "2"],
                 "--pipeline-virtual needs --rules pp",
                 id="argv3-item 6 part 2"),
    pytest.param(["--mesh", "data=1", "--max-devices", "0"],
                 r"--max-devices 0 out of range \(1\.\.2 visible\)",
                 id="argv4-item 6 part 2"),
    pytest.param(["--mesh", "data=1,stage=2", "--rules", "pp",
                  "--pipeline-microbatches", "3"],
                 "pipeline config: vision tower: local batch 32 not "
                 "divisible by 3 microbatches",
                 id="argv5-model=2 is not ported yet"),
    (["--rules", "dp"], "--rules needs --mesh"),
    (["--mesh", "data=3"], r"--mesh 'data=3': mesh \{'data': 3\} != 2"),
    (["--mesh", "data:2"], "expected axis=size"),
    (["--preset", "vit-base-patch16-224", "--mesh", "seq=2", "--rules",
      "sp"], r"--rules sp shards the batch over a 'data' axis"),
    (["--mesh", "seq=2", "--rules", "dp", "--loss", "siglip"],
     r"--rules dp with --loss siglip shards the batch over a 'data' axis"),
    (["--pipeline-microbatches", "-1"],
     "--pipeline-microbatches must be >= 1"),
    (["--preset", "siglip2-base-patch16-256", "--naflex", "--mesh",
      "data=1,stage=2", "--rules", "pp"],
     "--naflex needs attention masks, which the pipelined path does not"),
    (["--mesh", "data=1,stage=2", "--rules", "pp", "--pipeline-virtual",
      "2", "--pipeline-microbatches", "3", "--batch-size", "6"],
     "pipeline config: vision tower: interleaved schedule needs "
     "microbatches 3 divisible by 2 stages"),
    (["--mesh", "stage=2", "--rules", "pp"],
     r"--rules pp with --loss siglip shards the batch over a 'data'"),
])
def test_train_refusals(argv, match, monkeypatch):
    # two ranks planned: the mesh is checked before any group is made
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = cli.build_parser().parse_args(["train", "--tiny", "--device",
                                          "cpu", *argv])
    with pytest.raises(SystemExit, match=match):
        cli.cmd_train(args)
    assert not cli.torch.distributed.is_initialized()


def test_probe_runs_its_cases_on_gloo_ranks(capsys):
    from jimm_tpu_torch.parallel import probe
    assert probe.main(["--device", "cpu", "--cases",
                       "all_to_all_single_uneven,reduce_scatter_tensor"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["backend"] == "gloo" and out["world"] == 2
    assert out["cases"] == {"all_to_all_single_uneven": "ok",
                            "reduce_scatter_tensor": "ok"}
