"""Scheduling results for the ragged inference engine.

Copy of ``hcache_deepspeed_tpu/inference/scheduling.py``:
``SchedulingResult`` / ``SchedulingError`` returned by
``InferenceEngineV2.can_schedule``, and the backpressure action that clears
each verdict.
"""

from enum import Enum


class SchedulingResult(Enum):
    Success = 0
    EngineSequenceLimitExceeded = 1
    BatchSequenceLimitExceeded = 2
    BatchTokenLimitExceeded = 3
    KVCacheLimitExceeded = 4
    SequenceTokenLimitExceeded = 5


class BackpressureAction(Enum):
    """What a serving scheduler should do about one can_schedule verdict.

    Each rejection maps to a distinct action because each names a
    different exhausted resource with a different release schedule:
    """
    #: Success — admit the request into this step's ragged batch.
    ADMIT = 0
    #: EngineSequenceLimitExceeded — every tracked-sequence slot is
    #: held; slots free when a sequence finishes (or, in latent-preempt
    #: mode, is evicted wholesale), so the request waits in queue.
    WAIT_TRACKED_SLOT = 1
    #: BatchSequenceLimitExceeded — THIS forward's lane budget is full;
    #: nothing is wrong with the request, stop admitting and retry at
    #: the next step.
    NEXT_STEP = 2
    #: BatchTokenLimitExceeded — this candidate's prompt overflows the
    #: per-forward token budget; a shorter queued prompt may still fit,
    #: so skip the candidate but keep scanning the queue.
    SKIP_CANDIDATE = 3
    #: KVCacheLimitExceeded — block-pool pressure; the scheduler can
    #: manufacture free blocks by suspending victims to host.
    PREEMPT = 4
    #: SequenceTokenLimitExceeded — prompt + generation exceeds
    #: max_context; no amount of waiting or preemption fixes it.
    REJECT = 5


#: SchedulingResult -> the distinct backpressure action that clears it.
BACKPRESSURE_ACTION = {
    SchedulingResult.Success: BackpressureAction.ADMIT,
    SchedulingResult.EngineSequenceLimitExceeded:
        BackpressureAction.WAIT_TRACKED_SLOT,
    SchedulingResult.BatchSequenceLimitExceeded:
        BackpressureAction.NEXT_STEP,
    SchedulingResult.BatchTokenLimitExceeded:
        BackpressureAction.SKIP_CANDIDATE,
    SchedulingResult.KVCacheLimitExceeded: BackpressureAction.PREEMPT,
    SchedulingResult.SequenceTokenLimitExceeded:
        BackpressureAction.REJECT,
}


class SchedulingError(RuntimeError):
    def __init__(self, result: SchedulingResult) -> None:
        self.result = result
        super().__init__(f"Batch scheduling failed with result {result}")
