"""KV-cache block allocator.

Copy of ``hcache_deepspeed_tpu/inference/ragged/blocked_allocator.py``: a
free-list allocator handing out fixed-size KV cache block ids, kept on the
host (only the indices built from them reach the device). Free-list order
and refcounts match the JAX package step for step.

Blocks are reference-counted so prefix caching can share a full block
across sequences: ``allocate`` hands out blocks at refcount 1,
``acquire`` adds a reference, ``free`` drops one and only returns the
block to the free list when the count reaches zero.
"""

from typing import Dict, Iterable, List


class BlockedAllocator:

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks))
        self._refs: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def num_blocks(self) -> int:
        return self._num_blocks

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def allocate(self, num_blocks: int) -> List[int]:
        if num_blocks < 1:
            raise ValueError(f"invalid allocation size {num_blocks}")
        if num_blocks > len(self._free):
            raise ValueError(
                f"cannot allocate {num_blocks} blocks, only "
                f"{len(self._free)} free")
        out, self._free = self._free[:num_blocks], self._free[num_blocks:]
        for b in out:
            self._refs[b] = 1
        return out

    def acquire(self, block: int) -> int:
        """Add a reference to an already-allocated block (prefix
        sharing)."""
        if self._refs.get(block, 0) < 1:
            raise ValueError(f"cannot acquire unallocated block {block}")
        self._refs[block] += 1
        return block

    def free(self, blocks: Iterable[int]) -> None:
        blocks = list(blocks)
        drops: Dict[int, int] = {}
        for b in blocks:
            if not 0 <= b < self._num_blocks:
                raise ValueError(f"invalid block id {b}")
            drops[b] = drops.get(b, 0) + 1
        for b, n in drops.items():
            # count duplicates within THIS call too: free([b, b]) with
            # one reference held is a double free, not two decrements
            if self._refs.get(b, 0) < n:
                raise ValueError(f"double free of block {b}")
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
