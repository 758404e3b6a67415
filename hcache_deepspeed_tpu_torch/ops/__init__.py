"""Kernel ops: one plain PyTorch version and one hand-written CUDA kernel
per op, and a launch counter per kernel.

Counterpart of ``hcache_deepspeed_tpu/ops/__init__.py``. There is no
switch that forces the plain path: the tensor's device decides. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel, or
the wrapper raises on a shape the kernel does not take. Kernels are
built from ``ops/csrc`` at first use (``ops/_build.py``).
"""

from dataclasses import dataclass
from typing import Dict, List


@dataclass
class KernelOp:
    """One op's kernel: its C entry, source, the TPU kernel it replaces,
    and how many times it was launched."""
    name: str
    kernel: str
    source: str
    replaces: str
    launches: int = 0

    def count_launch(self) -> None:
        self.launches += 1


_OPS: Dict[str, KernelOp] = {}


def register_kernel(name: str, *, kernel: str, source: str,
                    replaces: str) -> KernelOp:
    op = KernelOp(name, kernel, source, replaces)
    _OPS[name] = op
    return op


def _ensure_loaded() -> None:
    from . import paged_attention, rms_norm  # noqa: F401


def kernel_ops() -> Dict[str, KernelOp]:
    _ensure_loaded()
    return dict(_OPS)


def reset_launch_counts() -> None:
    for op in kernel_ops().values():
        op.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: op.launches for name, op in kernel_ops().items()}


def op_report() -> List[dict]:
    """Each op with its kernel entry, source and launch count."""
    return [{"op": op.name, "kernel": op.kernel, "source": op.source,
             "replaces": op.replaces, "launches": op.launches}
            for op in sorted(kernel_ops().values(), key=lambda o: o.name)]


__all__ = ["KernelOp", "register_kernel", "kernel_ops",
           "reset_launch_counts", "launch_counts", "op_report"]
