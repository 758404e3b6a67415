"""Inference stack (counterpart of ``hcache_deepspeed_tpu/inference``):
ragged batching over a paged KV cache + the HCache restore path."""

from .config import (HCacheConfig, KVCacheConfig,  # noqa: F401
                     RaggedInferenceEngineConfig, StateManagerConfig)
from .convert import params_from_jax  # noqa: F401
from .engine_v2 import InferenceEngineV2  # noqa: F401
from .scheduling import SchedulingError, SchedulingResult  # noqa: F401
