"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here carries the ``cuda`` marker and skips without a
CUDA device: a CUDA kernel has no CPU mode. This file imports neither
JAX nor the JAX package, so it also runs on the machine with the card,
which has no JAX (``--noconftest`` skips ``tests/conftest.py``, which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The case table is shared with ``test_torch_ops.py``, which holds the
plain versions against the JAX package on the CPU.

Tolerance: fp32 ``atol 1e-4`` (the same fp32 math in another order);
bf16 ``atol 2e-2`` on O(1) inputs (paged attention) and one bf16 ulp
relative (RMSNorm).
"""

import numpy as np
import pytest
import torch

from hcache_deepspeed_tpu_torch import ops
from hcache_deepspeed_tpu_torch.ops import paged_attention as pa
from hcache_deepspeed_tpu_torch.ops import rms_norm as rn


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def pa_case(B, T, G, KV, D, BS, NBLK, NB, starts, lens, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, KV * G, D)).astype(np.float32)
    kp = rng.standard_normal((KV, NBLK * BS, D)).astype(np.float32)
    vp = rng.standard_normal((KV, NBLK * BS, D)).astype(np.float32)
    # out-of-order block tables: a shuffled slice of the pool per lane
    tables = rng.permutation(NBLK)[:B * NB].reshape(B, NB).astype(np.int32)
    start = np.asarray(starts, np.int32)
    kv_len = np.asarray(lens, np.int32)
    return q, kp, vp, tables, start, kv_len


PA_CASES = {
    # name: (B, T, G, KV, D, BS, NBLK, NB, starts, lens)
    "decode_mha_empty_lane": (4, 1, 1, 2, 64, 16, 32, 4,
                              [0, 5, 33, 0], [1, 6, 34, 0]),
    "decode_g2": (3, 1, 2, 2, 128, 8, 32, 8, [0, 17, 40], [1, 18, 41]),
    "decode_g4_empty_lane": (3, 1, 4, 2, 64, 16, 32, 4,
                             [10, 0, 50], [11, 0, 51]),
    "prefill_g1_start0": (1, 16, 1, 4, 64, 8, 16, 4, [0], [16]),
    "prefill_g2_start_gt0": (1, 16, 2, 2, 128, 8, 32, 8, [24], [40]),
    "prefill_g4_start_gt0_padded_rows": (2, 12, 4, 1, 64, 16, 32, 4,
                                         [20, 3], [29, 15]),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PA_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_matches_plain(cuda_device, name, dtype):
    arrays = pa_case(*PA_CASES[name])
    BS = PA_CASES[name][5]
    q, kp, vp, tables, start, kv_len = (t(a).to(cuda_device)
                                        for a in arrays)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    ops.reset_launch_counts()
    out = pa.paged_attention(q, kp, vp, tables, start, kv_len, BS)
    ref = pa.reference_paged_attention(q, kp, vp, tables, start, kv_len, BS)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention"] == 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4096), (3, 64)])
def test_cuda_rms_norm_matches_plain(cuda_device, dtype, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(*shape, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda_device).to(dtype)
    out = rn.rms_norm(x, w, 1e-5)
    ref = rn.reference_rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert ((out.float() - ref.float()).abs()
            <= rel * ref.float().abs() + 1e-6).all()


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine(cuda_device):
    """The slice as a whole on the card: the same small fp32 model and
    the same calls on a CUDA engine (kernels) and a CPU engine (plain
    versions): chunked prefill, ragged decode, flush -> restore_kv ->
    decode, suspend -> resume -> decode."""
    from hcache_deepspeed_tpu_torch.inference import (
        InferenceEngineV2, RaggedInferenceEngineConfig)
    from hcache_deepspeed_tpu_torch.models.llama import (llama_tiny,
                                                         random_params)
    cfg = llama_tiny(hidden_size=256, intermediate_size=512, n_head=4,
                     n_kv_head=2)                      # head dim 64
    kw = dict(kv_cache={"block_size": 16, "num_blocks": 32,
                        "cache_dtype": "float32"},
              state_manager={"prefill_chunk": 16},
              hcache={"restore_chunk_layers": 1})
    engines = [InferenceEngineV2(cfg, random_params(cfg, seed=0),
                                 config=RaggedInferenceEngineConfig(**kw),
                                 device=dev)
               for dev in ("cpu", cuda_device)]
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, (n,))) for n in (21, 7)]

    def both(uids, toks):
        outs = [e.put(uids, toks) for e in engines]
        torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-3,
                                   rtol=0)
        assert engines[1].serialize() == engines[0].serialize()
        return outs[0]

    ops.reset_launch_counts()
    logits, lat = both([1, 2], prompts)
    for _ in range(3):
        logits, step_lat = both([1, 2], [[int(r.argmax())] for r in logits])
    for e in engines:
        e.flush(1)
        e.restore_kv([1], [prompts[0]], [lat[0]])
    both([1], [[5]])
    for e in engines:
        e.suspend_sequence(2)
    both([3], [prompts[1]])
    for e in engines:
        e.resume_sequence(2)
    both([1, 2, 3], [[6], [7], [8]])
    counts = ops.launch_counts()
    assert counts["paged_attention"] > 0 and counts["rms_norm"] > 0
