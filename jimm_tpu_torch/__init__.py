"""jimm_tpu_torch: the PyTorch/CUDA port of jimm_tpu for one NVIDIA H100.

Same module names as the JAX package (``configs``, ``ops``, ``nn``,
``models``, ``weights``, ``serve``, ``cli``), written in PyTorch. Every
Pallas kernel on the served path is a CUDA kernel written for Hopper
(``csrc/``), built with ``nvcc`` at first use (``_build.py``) and held
against a plain PyTorch version of the same function. The ViT, CLIP and
SigLIP models load and export HF checkpoints (``from_pretrained``,
``save_pretrained``). The package imports nothing of JAX and nothing of
``jimm_tpu``.
"""

from jimm_tpu_torch.configs import (CLIPConfig, SigLIPConfig, ViTConfig,
                                    preset, with_runtime)
from jimm_tpu_torch.models.clip import CLIP
from jimm_tpu_torch.models.siglip import SigLIP, load_jax_params
from jimm_tpu_torch.models.vit import VisionTransformer

__all__ = ["CLIP", "CLIPConfig", "SigLIP", "SigLIPConfig", "ViTConfig",
           "VisionTransformer", "load_jax_params", "preset", "with_runtime"]
