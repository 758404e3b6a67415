"""Rotary position embeddings, plain PyTorch.

Counterpart of ``hcache_deepspeed_tpu/ops/rope.py``, which has no Pallas
kernel either: the rotation is elementwise and stays next to the QKV
projection. The cos/sin tables are float32; the rotation multiplies the
input by them in float32 and casts back to the input dtype.
"""

import torch


def rope_frequencies(head_dim, max_positions, theta=10000.0,
                     dtype=torch.float32, device=None):
    """[max_positions, head_dim // 2] cos and sin tables."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_positions, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x, cos, sin, positions=None):
    """x: [B, T, H, D]; cos/sin: [P, D // 2]; positions: [B, T] (default
    0..T-1). Pairs (x_i, x_{i + D/2}) are rotated (GPT-NeoX / llama
    convention)."""
    B, T, H, D = x.shape
    if positions is None:
        c = cos[:T][None, :, None, :]
        s = sin[:T][None, :, None, :]
    else:
        c = cos[positions][:, :, None, :]
        s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = c.float(), s.float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
