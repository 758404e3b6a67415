"""Inference-v2 engine configuration.

Counterpart of ``hcache_deepspeed_tpu/inference/config.py`` as plain
dataclasses: the same field names and defaults, nested blocks given as
dicts are built into their dataclass (``RaggedInferenceEngineConfig(
state_manager={...})``), and the ``ge=0`` bounds raise ``ValueError``.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the configs name dtypes as
    strings, as the JAX package's do)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _non_negative(obj, *names):
    for name in names:
        if getattr(obj, name) < 0:
            raise ValueError(f"{type(obj).__name__}.{name} must be >= 0, "
                             f"got {getattr(obj, name)}")


@dataclass
class KVCacheConfig:
    """'reserve' (fraction of free device memory) or an explicit block
    count."""
    block_size: int = 64              # tokens per KV block
    num_blocks: Optional[int] = None  # explicit pool size
    memory_fraction: float = 0.8      # used when num_blocks is None
    cache_dtype: str = "bfloat16"


@dataclass
class StateManagerConfig:
    max_tracked_sequences: int = 2048
    max_ragged_batch_size: int = 768      # max total tokens per forward
    max_ragged_sequence_count: int = 512  # max sequences per forward
    max_context: int = 8192               # max tokens of any one sequence
    #: > 0: prefills longer than this process in chunks of this size
    #: (Dynamic SplitFuse): prompt length is then bounded by max_context,
    #: not by the per-forward token budget
    prefill_chunk: int = 0
    #: share full KV blocks across identical prompt prefixes (not ported
    #: yet: the engine raises when it is set)
    prefix_caching: bool = False

    def __post_init__(self):
        _non_negative(self, "prefill_chunk")


@dataclass
class HCacheConfig:
    """Latent capture + restore_kv."""
    enable_latents: bool = True
    #: layers replayed per restore dispatch; 0 = auto: group layers so
    #: each chunk's latent slab is about restore_chunk_bytes
    restore_chunk_layers: int = 0
    restore_chunk_bytes: int = 64 * 1024 * 1024
    #: dtype latents are captured, stored and shipped in; "" = the
    #: model's compute dtype (bit-exact restore)
    latent_dtype: str = ""

    def __post_init__(self):
        _non_negative(self, "restore_chunk_layers")


@dataclass
class QuantizationConfig:
    """Weight-only serving quantization (not ported yet: the engine
    raises when it is enabled)."""
    enabled: bool = False
    bits: int = 8
    group_size: int = 256
    min_size: int = 4096
    use_fused_kernel: bool = True


@dataclass
class RaggedInferenceEngineConfig:
    state_manager: StateManagerConfig = field(
        default_factory=StateManagerConfig)
    kv_cache: KVCacheConfig = field(default_factory=KVCacheConfig)
    hcache: HCacheConfig = field(default_factory=HCacheConfig)
    quantization: QuantizationConfig = field(
        default_factory=QuantizationConfig)
    tensor_parallel: int = 1

    def __post_init__(self):
        for name, cls in (("state_manager", StateManagerConfig),
                          ("kv_cache", KVCacheConfig),
                          ("hcache", HCacheConfig),
                          ("quantization", QuantizationConfig)):
            value = getattr(self, name)
            if isinstance(value, dict):
                setattr(self, name, cls(**value))
