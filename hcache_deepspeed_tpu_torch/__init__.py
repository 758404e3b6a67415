"""hcache_deepspeed_tpu_torch: the PyTorch/CUDA port of hcache_deepspeed_tpu.

Same module names and public names as the JAX package, written for one
NVIDIA Hopper GPU. The JAX package's Pallas kernels become hand-written
CUDA C++ kernels (``ops/csrc``); everything else is plain PyTorch. The
first slice carries the HCache serving path: ``inference.InferenceEngineV2``
over a paged KV cache with latent capture and ``restore_kv``.

Importing the package loads no kernel and touches no device.
"""

from .version import __version__  # noqa: F401
