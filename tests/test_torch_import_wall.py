"""The port stands alone: `jimm_tpu_torch` and `chip_smoke.py` import
nothing of JAX and nothing of `jimm_tpu`; entry points default to the card
and refuse to carry on without it; the kernel build names sm_90a and every
CUDA source."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from jimm_tpu_torch import _build, configs
from jimm_tpu_torch.models.siglip import SigLIP
from test_torch_siglip import tiny_config

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "jimm_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    for p in (REPO / "jimm_tpu_torch").rglob("*.py")
    if p.name != "__main__.py")


#: what neither the port nor chip_smoke.py may load: JAX, its libraries
#: (orbax is the reference's checkpoint storage; grain, the reference's
#: indexed loader, loads JAX) and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "grain", "jimm_tpu")


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(MODULES) >= 23
    # the NaFlex slice keeps its own copies of the JAX package's jax-free
    # data modules
    assert {"jimm_tpu_torch.nn.naflex", "jimm_tpu_torch.data.naflex",
            "jimm_tpu_torch.data.preprocess"} <= set(MODULES)
    # so do the checkpoint and resilience slice's (the JAX obs registry,
    # journal, spans and goodput, resilience/*), and its checkpoints keep
    # their own storage, not orbax
    assert {"jimm_tpu_torch.obs.__init__", "jimm_tpu_torch.obs.registry",
            "jimm_tpu_torch.obs.journal", "jimm_tpu_torch.obs.spans",
            "jimm_tpu_torch.obs.goodput", "jimm_tpu_torch.resilience.__init__",
            "jimm_tpu_torch.resilience.backoff",
            "jimm_tpu_torch.resilience.faults",
            "jimm_tpu_torch.resilience.preemption",
            "jimm_tpu_torch.resilience.supervisor",
            "jimm_tpu_torch.train.checkpoint"} <= set(MODULES)
    # and the file-dataset slice's: the native build, the prefetcher, and
    # the indexed loader in place of grain
    assert {"jimm_tpu_torch.data.native", "jimm_tpu_torch.data.pipeline",
            "jimm_tpu_torch.data.grain_pipeline"} <= set(MODULES)
    # and the parallelism slice's (torch.distributed, not jax.sharding)
    assert {"jimm_tpu_torch.parallel.__init__",
            "jimm_tpu_torch.parallel.mesh", "jimm_tpu_torch.parallel.comm",
            "jimm_tpu_torch.parallel.sharding",
            "jimm_tpu_torch.parallel.ring_attention",
            "jimm_tpu_torch.parallel.ulysses",
            "jimm_tpu_torch.parallel.seqpar",
            "jimm_tpu_torch.parallel.probe",
            "jimm_tpu_torch.parallel.pipeline"} <= set(MODULES)
    # and the elastic slice's copy of the reference's jax-free planner
    assert "jimm_tpu_torch.resilience.elastic" in MODULES
    # and the serving replicas slice's: the topology planner, the stdlib
    # client and the SLO engine
    assert {"jimm_tpu_torch.serve.topology", "jimm_tpu_torch.serve.client",
            "jimm_tpu_torch.obs.slo"} <= set(MODULES)
    # and the wide replicas and QoS slice's: the in-process mesh and the
    # copies of the reference's QoS package (policy and cli stdlib-only)
    assert {"jimm_tpu_torch.parallel.local",
            "jimm_tpu_torch.serve.qos.__init__",
            "jimm_tpu_torch.serve.qos.policy",
            "jimm_tpu_torch.serve.qos.scheduler",
            "jimm_tpu_torch.serve.qos.pool",
            "jimm_tpu_torch.serve.qos.cli"} <= set(MODULES)


def test_the_indexed_loader_loads_neither_jax_nor_grain():
    code = ("import sys\n"
            "import jimm_tpu_torch.data.grain_pipeline\n"
            "import jimm_tpu_torch.data.pipeline\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'grain'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)], names


def test_default_device_is_the_card():
    cfg = tiny_config(configs)
    if torch.cuda.is_available():
        model = SigLIP(cfg)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SigLIP(cfg)
    assert next(SigLIP(cfg, device="cpu").parameters()).device.type == "cpu"


def test_serve_cli_defaults_to_the_card():
    from jimm_tpu_torch.cli import build_parser
    args = build_parser().parse_args(["serve"])
    assert args.device == "cuda"
    assert args.preset == "siglip-base-patch16-256"


def test_build_command_names_sm90a_and_every_source():
    """One nvcc per source, each for sm_90a, then one link of the objects."""
    obj_dir = REPO / "build" / "obj"
    compiles = _build.compile_commands(obj_dir)
    cus = sorted(str(p) for p in (REPO / "jimm_tpu_torch" / "csrc").glob("*.cu"))
    assert len(cus) == 9
    assert sorted(cmd[-1] for cmd, _ in compiles) == cus
    for cmd, obj in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert {"-c", "-O3", "-std=c++17"} <= set(cmd)
        assert obj.parent == obj_dir and str(obj) in cmd
    link = _build.link_command([obj for _, obj in compiles], REPO / "x.so")
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert _build.library_path().parent == REPO / "build" / "jimm_tpu_torch"
    assert _build.library_path().name.startswith("libjimm_kernels_")


def test_every_signature_is_an_exported_function():
    """``_build._SIGNATURES`` names exactly the ``extern "C"`` entry points
    of the CUDA sources, each with as many argtypes as parameters."""
    import re
    exported = {}
    for src in _build.sources():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            exported[name] = len(params.split(","))
    assert exported == {name: len(argtypes) for name, argtypes
                        in _build._SIGNATURES.items()}


#: the one module that may open a torch.profiler session itself: every
#: other caller goes through its profiler_session or CaptureManager, which
#: hold the process-wide session lock (a second kineto session raises)
PROFILER_HOME = REPO / "jimm_tpu_torch" / "obs" / "prof" / "capture.py"


def _profiler_calls(tree: ast.AST) -> list[int]:
    """Lines that name ``torch.profiler.profile`` (or the same function
    imported from ``torch.profiler``, or ``torch.autograd.profiler``'s
    ``profile``)."""
    lines = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "profile" \
                and isinstance(node.value, ast.Attribute) \
                and node.value.attr == "profiler":
            lines.append(node.lineno)
        elif isinstance(node, ast.ImportFrom) and node.module in (
                "torch.profiler", "torch.autograd.profiler") \
                and any(a.name == "profile" for a in node.names):
            lines.append(node.lineno)
    return lines


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_profiler_sessions_open_only_in_capture(path):
    calls = _profiler_calls(ast.parse(path.read_text(), str(path)))
    if path == PROFILER_HOME:
        assert calls, "the capture module lost its profiler session"
    else:
        assert not calls, (f"{path.name} opens torch.profiler.profile at "
                           f"lines {calls}: use obs.prof.profiler_session")


def test_the_observability_slice_keeps_its_own_copies():
    """The JAX package's jax-free obs modules and its checkpoint quantizer
    have their own copies in the port (the subprocess test above imports
    every one of them and finds no JAX)."""
    assert {"jimm_tpu_torch.obs.exporters", "jimm_tpu_torch.obs.timeline",
            "jimm_tpu_torch.obs.cli", "jimm_tpu_torch.obs.prof.capture",
            "jimm_tpu_torch.obs.prof.memory",
            "jimm_tpu_torch.obs.prof.opstats",
            "jimm_tpu_torch.train.profile",
            "jimm_tpu_torch.weights.quantize"} <= set(MODULES)
