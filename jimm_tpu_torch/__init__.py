"""jimm_tpu_torch: the PyTorch/CUDA port of jimm_tpu for one NVIDIA H100.

Same module names as the JAX package (``configs``, ``ops``, ``nn``,
``models``, ``weights``, ``serve``, ``cli``), written in PyTorch. Every
Pallas kernel on the served path is a CUDA kernel written for Hopper
(``csrc/``), built with ``nvcc`` at first use (``_build.py``) and held
against a plain PyTorch version of the same function. The ViT, CLIP and
SigLIP models load and export HF checkpoints (``from_pretrained``,
``save_pretrained``). The package imports nothing of JAX and nothing of
``jimm_tpu``; its exports (and ``jimm_tpu_torch.serve``'s) import their
modules at first use, so that the host tools (``aot ls|gc|verify``,
``cascade calibrate|ls``) run without importing torch.
"""

_EXPORTS = {
    "CLIPConfig": "jimm_tpu_torch.configs",
    "SigLIPConfig": "jimm_tpu_torch.configs",
    "ViTConfig": "jimm_tpu_torch.configs",
    "preset": "jimm_tpu_torch.configs",
    "with_runtime": "jimm_tpu_torch.configs",
    "CLIP": "jimm_tpu_torch.models.clip",
    "SigLIP": "jimm_tpu_torch.models.siglip",
    "load_jax_params": "jimm_tpu_torch.models.siglip",
    "VisionTransformer": "jimm_tpu_torch.models.vit",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    """Import an export's module, or a submodule, at first use."""
    import importlib
    module = _EXPORTS.get(name)
    if module is not None:
        value = getattr(importlib.import_module(module), name)
    else:
        try:
            value = importlib.import_module(f"{__name__}.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value
    return value
