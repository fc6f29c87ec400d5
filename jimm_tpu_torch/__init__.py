"""jimm_tpu_torch: the PyTorch/CUDA port of jimm_tpu for one NVIDIA H100.

Same module names as the JAX package (``configs``, ``ops``, ``nn``,
``models``, ``serve``, ``cli``), written in PyTorch. Every Pallas kernel on
the served path is a CUDA kernel written for Hopper (``csrc/``), built with
``nvcc`` at first use (``_build.py``) and held against a plain PyTorch
version of the same function. The package imports nothing of JAX and
nothing of ``jimm_tpu``.
"""

from jimm_tpu_torch.configs import SigLIPConfig, preset, with_runtime
from jimm_tpu_torch.models.siglip import SigLIP, load_jax_params

__all__ = ["SigLIP", "SigLIPConfig", "load_jax_params", "preset",
           "with_runtime"]
