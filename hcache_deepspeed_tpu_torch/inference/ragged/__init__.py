"""Ragged batching state (counterpart of
``hcache_deepspeed_tpu/inference/ragged``)."""

from .blocked_allocator import BlockedAllocator  # noqa: F401
from .kv_cache import BlockedKVCache, StateManager  # noqa: F401
from .sequence import SequenceDescriptor  # noqa: F401
