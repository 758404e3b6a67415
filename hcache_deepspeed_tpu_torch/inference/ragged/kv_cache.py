"""Blocked (paged) KV cache + host-side state manager.

Counterpart of ``hcache_deepspeed_tpu/inference/ragged/kv_cache.py``. One
pool per k/v of shape ``[L, KV, P, D]`` with ``P = num_blocks *
block_size`` token slots, on the device. Head-major, so one layer's pool
``[KV, P, D]`` hands the paged-attention kernel a ``[block_size, D]`` tile
per (head, block). The JAX package donates the pools to each compiled
forward and replaces them; here the forward and restore paths update them
in place (``index_copy_``), so no second pool is ever allocated.
``StateManager`` is copied from the JAX package.
"""

from typing import Dict, Optional

import numpy as np
import torch

from .blocked_allocator import BlockedAllocator
from .sequence import SequenceDescriptor


class BlockedKVCache:
    """Device block pool for all layers of one model."""

    def __init__(self, n_layers: int, num_blocks: int, block_size: int,
                 n_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 device="cpu"):
        self.n_layers = n_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        shape = (n_layers, n_kv_heads, num_blocks * block_size, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)

    @staticmethod
    def token_bytes(n_layers: int, n_kv_heads: int, head_dim: int,
                    dtype: torch.dtype) -> int:
        """KV bytes per cached token (k + v across all layers)."""
        return 2 * n_layers * n_kv_heads * head_dim * dtype.itemsize

    @property
    def per_token_bytes(self) -> int:
        return self.token_bytes(self.n_layers, self.n_kv_heads,
                                self.head_dim, self.dtype)


class StateManager:
    """uid → SequenceDescriptor tracking + block budget arithmetic."""

    def __init__(self, max_tracked_sequences: int, num_blocks: int,
                 block_size: int, max_seq_len: int):
        self.max_tracked_sequences = max_tracked_sequences
        self.block_size = block_size
        self.max_seq_len = max_seq_len
        self.allocator = BlockedAllocator(num_blocks)
        self._seqs: Dict[int, SequenceDescriptor] = {}

    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    def get_sequence(self, uid: int) -> Optional[SequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid: int) -> SequenceDescriptor:
        seq = self._seqs.get(uid)
        if seq is None:
            if len(self._seqs) >= self.max_tracked_sequences:
                raise RuntimeError(
                    f"sequence limit {self.max_tracked_sequences} reached")
            seq = SequenceDescriptor(uid)
            self._seqs[uid] = seq
        return seq

    def blocks_needed(self, seq: Optional[SequenceDescriptor],
                      new_tokens: int) -> int:
        seen = seq.seen_tokens if seq else 0
        have = seq.cur_allocated_blocks if seq else 0
        total = seen + new_tokens
        need = -(-total // self.block_size)  # ceil
        return max(need - have, 0)

    def maybe_allocate_kv(self, seq: SequenceDescriptor,
                          new_tokens: int) -> None:
        need = self.blocks_needed(seq, new_tokens)
        if need:
            seq.extend_blocks(self.allocator.allocate(need))

    def flush_sequence(self, uid: int) -> None:
        seq = self._seqs.pop(uid, None)
        if seq is None:
            return
        if seq.blocks:
            self.allocator.free(seq.blocks)

    def block_table(self, seq: SequenceDescriptor,
                    max_blocks: int) -> np.ndarray:
        """Padded int32 block table; unused entries point at block 0 but are
        never read/written thanks to length masks."""
        table = np.zeros((max_blocks,), np.int32)
        n = min(len(seq.blocks), max_blocks)
        table[:n] = seq.blocks[:n]
        return table
