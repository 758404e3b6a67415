"""RMSNorm forward.

Counterpart of ``hcache_deepspeed_tpu/ops/rms_norm.py``. On a CUDA tensor
:func:`rms_norm` launches ``csrc/rms_norm.cu`` (which replaces the TPU
kernel ``_rms_kernel``); on a CPU tensor it runs
:func:`reference_rms_norm`. Forward only: the JAX backward (``_rms_bwd``)
is plain jnp, and its autograd Function comes with the training slice.
"""

import torch

from . import register_kernel

OP = register_kernel(
    "rms_norm", kernel="hds_rms_norm",
    source="hcache_deepspeed_tpu_torch/ops/csrc/rms_norm.cu",
    replaces="hcache_deepspeed_tpu/ops/rms_norm.py:26")

_DTYPES = (torch.float32, torch.bfloat16)


def reference_rms_norm(x, weight, eps=1e-6):
    """fp32 mean of squares, times rsqrt(mean + eps), times the weight,
    cast back to the input dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def cuda_rms_norm(x, weight, eps=1e-6):
    """Launch the CUDA kernel on ``x [..., H]`` (contiguous, bf16 or fp32,
    H a multiple of 8) and ``weight [H]``."""
    from . import _build
    H = x.shape[-1]
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError("cuda_rms_norm needs x and weight on one CUDA "
                         "device")
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtypes {x.dtype}, {weight.dtype}")
    if weight.shape != (H,) or H % 8:
        raise ValueError(f"need weight [{H}] and H % 8 == 0, got "
                         f"{tuple(weight.shape)}")
    if not (x.is_contiguous() and weight.is_contiguous()) or \
            x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned, "
                         "weight contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // H if H else 0
    lib = _build.load_library()
    err = lib.hds_rms_norm(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, H,
        float(eps), _build.dtype_code(x.dtype),
        _build.dtype_code(weight.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "hds_rms_norm")
    OP.count_launch()
    return out


def rms_norm(x, weight, eps=1e-6):
    """Plain version on the CPU, the kernel on the card."""
    if x.device.type == "cpu":
        return reference_rms_norm(x, weight, eps)
    return cuda_rms_norm(x, weight, eps)
