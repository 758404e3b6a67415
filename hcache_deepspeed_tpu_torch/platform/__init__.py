"""Device resolution, memory, trace annotation and the card's identity.

Counterpart of ``hcache_deepspeed_tpu/platform`` for one CUDA device.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request, :func:`resolve_device` raises
instead of quietly running on the host.
"""

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; ``"cpu"`` must be asked
    for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def available_memory(device: torch.device) -> int:
    """Free device bytes (0 = unknown, as on the CPU)."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free)
    return 0


def annotate(name: str):
    """Context manager adding a named range to profiler traces."""
    return torch.profiler.record_function(name)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_report() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
