"""The port's ops against the JAX package's, on the same numpy inputs.

The plain PyTorch versions run here on the CPU and are held against the
JAX references (and, for paged attention, against the Pallas kernel in
interpret mode). The CUDA kernels are held against the plain versions on
the same cases by ``test_torch_cuda.py``, on the card.

Tolerance: fp32 ``atol 1e-5`` (the same fp32 math in another summation
order); on the card, the bf16 tolerances ``chip_smoke.py`` states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcache_deepspeed_tpu.ops.paged_attention import (
    pallas_paged_attention, reference_paged_attention as jax_paged_attention)
from hcache_deepspeed_tpu.ops.rms_norm import (
    reference_rms_norm as jax_rms_norm)
from hcache_deepspeed_tpu.ops.rope import (apply_rope as jax_apply_rope,
                                           rope_frequencies as jax_rope_freqs)
from hcache_deepspeed_tpu_torch import ops
from hcache_deepspeed_tpu_torch.ops import paged_attention as pa
from hcache_deepspeed_tpu_torch.ops import rms_norm as rn
from hcache_deepspeed_tpu_torch.ops.rope import apply_rope, rope_frequencies

from .test_torch_cuda import PA_CASES, pa_case

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ #
# RMSNorm
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 128), (1, 4096)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    ref = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    out = rn.rms_norm(t(x), t(w), 1e-5)
    assert out.dtype == torch.float32 and out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_rms_norm_cpu_takes_plain_path_without_launch():
    ops.reset_launch_counts()
    x = torch.ones(2, 8)
    rn.rms_norm(x, torch.ones(8))
    assert ops.launch_counts()["rms_norm"] == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        rn.cuda_rms_norm(torch.ones(2, 8), torch.ones(8))
    q = torch.zeros(1, 1, 2, 64)
    pool = torch.zeros(2, 16, 64)
    i32 = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        pa.cuda_paged_attention(q, pool, pool, i32.view(1, 1), i32, i32, 8)


def test_op_report_lists_both_kernels():
    rep = {r["op"]: r for r in ops.op_report()}
    assert set(rep) == {"paged_attention", "rms_norm"}
    for r in rep.values():
        assert r["kernel"].startswith("hds_")
        assert r["source"].endswith(".cu")
        assert r["replaces"].startswith("hcache_deepspeed_tpu/ops/")


# ------------------------------------------------------------------ #
# RoPE (plain torch on both sides of the port: no kernel owed)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("D,P,theta", [(16, 128, 10000.0),
                                       (128, 4096, 500000.0)])
def test_rope_frequencies_match_jax(D, P, theta):
    jc, js = jax_rope_freqs(D, P, theta)
    c, s = rope_frequencies(D, P, theta)
    assert c.dtype == torch.float32
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL)


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope_matches_jax(with_positions):
    rng = np.random.default_rng(1)
    B, T, H, D = 2, 5, 3, 16
    x = rng.standard_normal((B, T, H, D)).astype(np.float32)
    pos = rng.integers(0, 64, (B, T)).astype(np.int64) \
        if with_positions else None
    jc, js = jax_rope_freqs(D, 64)
    ref = jax_apply_rope(jnp.asarray(x), jc, js,
                         None if pos is None else jnp.asarray(pos))
    c, s = rope_frequencies(D, 64)
    out = apply_rope(t(x), c, s, None if pos is None else t(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_apply_rope_casts_back_to_input_dtype():
    x = torch.randn(1, 2, 2, 8, generator=torch.Generator().manual_seed(0))
    c, s = rope_frequencies(8, 4)
    out = apply_rope(x.to(torch.bfloat16), c, s)
    assert out.dtype == torch.bfloat16
    ref = apply_rope(x.to(torch.bfloat16).float(), c, s)
    torch.testing.assert_close(out.float(), ref, atol=2 ** -7 * 4, rtol=0)


# ------------------------------------------------------------------ #
# Paged attention
# ------------------------------------------------------------------ #
def _pa_run(case):
    q, kp, vp, tables, start, kv_len = pa_case(*case)
    BS = case[5]
    out = pa.paged_attention(t(q), t(kp), t(vp), t(tables), t(start),
                             t(kv_len), BS).numpy()
    return out, (q, kp, vp, tables, start, kv_len, BS)


@pytest.mark.parametrize("name", sorted(PA_CASES))
def test_paged_attention_matches_jax_reference(name):
    """Rows with at least one valid column (the JAX reference averages V
    uniformly over a row with none; the port writes zeros there, as the
    TPU kernel does)."""
    out, (q, kp, vp, tables, start, kv_len, BS) = _pa_run(PA_CASES[name])
    ref = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), tables,
        jnp.asarray(start), jnp.asarray(kv_len), BS))
    T = q.shape[1]
    rows = start[:, None] + np.arange(T)[None, :]
    has_col = np.minimum(rows + 1, kv_len[:, None]) > 0        # [B, T]
    assert has_col.any()
    np.testing.assert_allclose(out[has_col], ref[has_col], atol=ATOL)


@pytest.mark.parametrize("name", sorted(PA_CASES))
def test_paged_attention_matches_pallas_kernel(name):
    """All rows, empty ones included, against the TPU kernel run in
    interpret mode."""
    out, (q, kp, vp, tables, start, kv_len, BS) = _pa_run(PA_CASES[name])
    ref = np.asarray(pallas_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), tables,
        jnp.asarray(start), jnp.asarray(kv_len), BS, interpret=True))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_paged_attention_empty_lane_is_zero():
    out, (_, _, _, _, _, kv_len, _) = _pa_run(PA_CASES["decode_g4_empty_lane"])
    assert kv_len[1] == 0
    assert np.all(out[1] == 0.0)
    assert np.all(np.isfinite(out))
