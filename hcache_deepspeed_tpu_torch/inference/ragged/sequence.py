"""Per-sequence host-side state.

Copy of ``hcache_deepspeed_tpu/inference/ragged/sequence.py``: seen
tokens, in-flight tokens and the KV block ids of one sequence. Only the
block table reaches the device, as gather and scatter indices built per
forward.
"""

from typing import List


class SequenceDescriptor:

    def __init__(self, uid: int):
        self.uid = uid
        self.seen_tokens = 0            # tokens whose KV is materialized
        self.in_flight_tokens = 0       # tokens in the current forward
        self.blocks: List[int] = []     # KV pool block ids, in order
        #: host copy of the KV while suspended (engine.suspend_sequence;
        #: reference: BlockedKVCache's host-offloaded blocks)
        self.host_kv = None

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self.blocks)

    def extend_blocks(self, new_blocks: List[int]) -> None:
        self.blocks.extend(new_blocks)

    def pre_forward(self, num_tokens: int) -> None:
        self.in_flight_tokens = num_tokens

    def post_forward(self) -> None:
        self.seen_tokens += self.in_flight_tokens
        self.in_flight_tokens = 0

    def __repr__(self):
        return (f"SequenceDescriptor(uid={self.uid}, "
                f"seen={self.seen_tokens}, blocks={len(self.blocks)})")
