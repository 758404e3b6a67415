"""Ragged paged attention, the inference engine's hot op.

Counterpart of ``hcache_deepspeed_tpu/ops/paged_attention.py``. On CUDA
tensors :func:`paged_attention` launches ``csrc/paged_attention.cu``
(which replaces the TPU kernel ``_kernel``); on CPU tensors it runs
:func:`reference_paged_attention`.

Contract (as ``inference/model.py`` calls it):

* ``q``       [B, T, Hq, D]: T = 1 for a ragged decode batch, or a prefill
  chunk whose rows sit at positions ``start[b] + t``;
* ``k_pool``/``v_pool`` [KV, P, D]: one layer's flat block pool,
  P = number of blocks * block_size;
* ``tables``  [B, NB] int32 block table, ``start`` and ``kv_len`` [B] int32.

Row ``t`` of sequence ``b`` attends the cached positions ``col`` with
``col <= start[b] + t`` and ``col < kv_len[b]``. A row with no such column
(a padded lane, ``kv_len = 0``) comes out as zeros. That follows the TPU
kernel's ``l == 0`` guard; the JAX ``reference_paged_attention`` instead
averages V uniformly there. Both are read only for rows whose output is
discarded.
"""

import math

import torch

from . import register_kernel

OP = register_kernel(
    "paged_attention", kernel="hds_paged_attention",
    source="hcache_deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
    replaces="hcache_deepspeed_tpu/ops/paged_attention.py:77")

_NEG_INF = -1e30    # finite: a fully masked row can never produce NaN
_DTYPES = (torch.float32, torch.bfloat16)


def reference_paged_attention(q, k_pool, v_pool, tables, start, kv_len,
                              block_size):
    """Dense-gather plain version, fp32 throughout, [B, T, Hq, D] out."""
    B, T, Hq, D = q.shape
    KV = k_pool.shape[0]
    G = Hq // KV
    BS = block_size
    S = tables.shape[1] * BS
    dev = q.device
    pos = torch.arange(S, device=dev)
    tables = tables.to(device=dev, dtype=torch.long)
    gather = tables[:, pos // BS] * BS + pos % BS             # [B, S]
    k_seq = k_pool[:, gather].float()                         # [KV,B,S,D]
    v_seq = v_pool[:, gather].float()
    qg = q.reshape(B, T, KV, G, D).float()
    scores = torch.einsum("btkgd,kbsd->bkgts", qg, k_seq) * (
        1.0 / math.sqrt(D))
    start = start.to(device=dev, dtype=torch.long)
    kv_len = kv_len.to(device=dev, dtype=torch.long)
    q_pos = start[:, None] + torch.arange(T, device=dev)[None, :]   # [B,T]
    valid = (pos[None, None, :] <= q_pos[:, :, None]) & \
        (pos[None, None, :] < kv_len[:, None, None])          # [B, T, S]
    valid = valid[:, None, None]                              # [B,1,1,T,S]
    scores = scores.masked_fill(~valid, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    out = torch.einsum("bkgts,kbsd->bkgtd", p, v_seq) / denom
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


def cuda_paged_attention(q, k_pool, v_pool, tables, start, kv_len,
                         block_size):
    """Launch the CUDA kernel. Raises on any shape, dtype or layout it
    does not take: D in {64, 128}, block_size % 8 == 0, whole blocks in
    the pool, Hq % KV == 0, one dtype (bf16 or fp32) for q and the pools,
    int32 tables/start/kv_len, everything contiguous on one device.
    ``kv_len[b] <= NB * block_size`` is the caller's contract (it is not
    read back from the device)."""
    from . import _build
    B, T, Hq, D = q.shape
    KV, P = k_pool.shape[0], k_pool.shape[1]
    NB = tables.shape[1]
    BS = block_size
    tensors = (q, k_pool, v_pool, tables, start, kv_len)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in tensors):
        raise ValueError("cuda_paged_attention needs every input on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or \
            v_pool.dtype != q.dtype:
        raise ValueError(f"q and pools must share bf16 or fp32, got "
                         f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if any(t.dtype != torch.int32 for t in (tables, start, kv_len)):
        raise ValueError("tables, start and kv_len must be int32")
    if D not in (64, 128) or BS % 8 or P % BS or Hq % KV or \
            k_pool.shape != (KV, P, D) or v_pool.shape != (KV, P, D) or \
            tables.shape != (B, NB) or start.shape != (B,) or \
            kv_len.shape != (B,):
        raise ValueError(
            f"unsupported paged attention shapes: q {tuple(q.shape)}, "
            f"pool {tuple(k_pool.shape)}, tables {tuple(tables.shape)}, "
            f"block_size {BS}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged attention inputs must be contiguous")
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.hds_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), start.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), B, T, Hq, KV, D, P, NB, BS,
        1.0 / math.sqrt(D), _build.dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "hds_paged_attention")
    OP.count_launch()
    return out


def paged_attention(q, k_pool, v_pool, tables, start, kv_len, block_size):
    """Plain version on the CPU, the kernel on the card."""
    if q.device.type == "cpu":
        return reference_paged_attention(q, k_pool, v_pool, tables, start,
                                         kv_len, block_size)
    return cuda_paged_attention(q, k_pool, v_pool, tables, start, kv_len,
                                block_size)
