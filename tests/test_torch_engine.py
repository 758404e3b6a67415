"""The port's InferenceEngineV2 against the JAX package's, on the same
``llama_tiny`` weights (``LlamaForCausalLM.init``, converted by
``params_from_jax``), with fp32 cache and compute. The port runs with
``device="cpu"``, so RMSNorm and paged attention take their plain
versions.

Both engines receive the same calls in the same order, so besides the
outputs their allocator state (``serialize()``: per-sequence blocks in
order, free-block count) must be identical after every step.

Tolerances: logits ``atol 1e-4`` and latents ``atol 1e-5`` (fp32 math in
another summation order, compounded over two layers); greedy streams and
allocator state exactly.
"""

import jax
import numpy as np
import pytest
import torch

from hcache_deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from hcache_deepspeed_tpu.inference import (
    RaggedInferenceEngineConfig as JaxConfig)
from hcache_deepspeed_tpu.models.llama import LlamaForCausalLM
from hcache_deepspeed_tpu.models.llama import llama_tiny as jax_llama_tiny
from hcache_deepspeed_tpu_torch.inference import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig,
                                                  params_from_jax)
from hcache_deepspeed_tpu_torch.models.llama import llama_tiny

LOGITS_ATOL = 1e-4
LATENT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ENGINE_KW = dict(
    state_manager={"max_tracked_sequences": 8, "max_ragged_batch_size": 128,
                   "max_ragged_sequence_count": 4, "max_context": 128},
    kv_cache={"block_size": 16, "num_blocks": 24, "cache_dtype": "float32"})


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama_tiny(max_positions=128, use_flash=False)
    params = LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)},
        train=False)["params"]
    tcfg = llama_tiny(max_positions=128)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, params, tcfg, tparams


def make_pair(weights, **over):
    jcfg, params, tcfg, tparams = weights
    kw = {**ENGINE_KW, **over}
    return (JaxEngine(jcfg, params, config=JaxConfig(**kw)),
            InferenceEngineV2(tcfg, tparams,
                              config=RaggedInferenceEngineConfig(**kw),
                              device="cpu"))


@pytest.fixture(scope="module")
def engines(weights):
    """One JAX engine (and its port twin) for the module: its compiled
    programs are reused across tests. Each test flushes what it puts."""
    return make_pair(weights)


def put_both(engines, uids, tokens):
    """Same put on both engines; outputs and allocator state compared."""
    je, te = engines
    jl, jlat = je.put(uids, tokens)
    tl, tlat = te.put(uids, tokens)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), jl, atol=LOGITS_ATOL)
    for a, b in zip(jlat, tlat):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), a, atol=LATENT_ATOL)
    assert te.serialize() == je.serialize()
    return jl, jlat


def flush_both(engines, uids):
    for e in engines:
        for uid in uids:
            e.flush(uid)
    assert engines[1].serialize() == engines[0].serialize()


def prompt(rng, n):
    return [int(x) for x in rng.integers(0, 256, (n,))]


def test_prefill_matches_jax(engines):
    rng = np.random.default_rng(0)
    _, lat = put_both(engines, [1, 2], [prompt(rng, 13), prompt(rng, 7)])
    assert lat[0].shape == (2, 13, 64) and lat[1].shape == (2, 7, 64)
    flush_both(engines, [1, 2])


def test_ragged_decode_batch_matches_jax(engines):
    """Two decoding sequences + one fresh prefill in one put, then decode
    steps of three lanes (a bucket of 8: 5 padded lanes)."""
    rng = np.random.default_rng(1)
    put_both(engines, [1, 2], [prompt(rng, 7), prompt(rng, 20)])
    logits, lat = put_both(engines, [1, 2, 3],
                           [[5], [9], prompt(rng, 5)])
    assert lat[0].shape[1] == 1 and lat[2].shape[1] == 5
    for _ in range(3):
        nxt = [[int(np.argmax(row))] for row in logits]
        logits, _ = put_both(engines, [1, 2, 3], nxt)
    flush_both(engines, [1, 2, 3])


def test_chunked_prefill_matches_jax(weights):
    pair = make_pair(weights, state_manager={
        **ENGINE_KW["state_manager"], "prefill_chunk": 16})
    rng = np.random.default_rng(2)
    logits, lat = put_both(pair, [4, 5], [prompt(rng, 40), prompt(rng, 9)])
    assert lat[0].shape == (2, 40, 64)
    put_both(pair, [4, 5], [[int(np.argmax(row))] for row in logits])


def test_generate_greedy_streams_identical(engines):
    rng = np.random.default_rng(3)
    prompts = [prompt(rng, n) for n in (5, 11, 3)]
    je, te = engines
    jout = je.generate(prompts, max_new_tokens=6)
    tout = te.generate(prompts, max_new_tokens=6)
    assert tout == jout
    assert te.serialize() == je.serialize()


def test_generate_sampled_streams_identical(engines):
    """Temperature/top-k/top-p sampling on the host from one seeded numpy
    generator: identical streams as long as the logits agree closely."""
    rng = np.random.default_rng(4)
    prompts = [prompt(rng, n) for n in (6, 4)]
    je, te = engines
    kw = dict(max_new_tokens=5, temperature=0.8, top_k=20, top_p=0.9,
              seed=11)
    assert te.generate(prompts, **kw) == je.generate(prompts, **kw)


def _restore_cycle(engines, uid, tokens, latents, steps, first):
    """restore_kv from latents on both engines, then greedy decode."""
    je, te = engines
    je.restore_kv([uid], [tokens], [latents[0]])
    te.restore_kv([uid], [tokens], [torch.tensor(latents[0])])
    assert te.serialize() == je.serialize()
    stream, cur = [], first
    for _ in range(steps):
        logits, _ = put_both(engines, [uid], [[cur]])
        cur = int(np.argmax(logits[0]))
        stream.append(cur)
    return stream


def test_flush_restore_decode_matches_jax(engines):
    rng = np.random.default_rng(5)
    tokens = prompt(rng, 19)
    logits, lat = put_both(engines, [7], [tokens])
    first = int(np.argmax(logits[0]))
    # reference stream: the sequence that was never flushed
    ref = []
    cur = first
    for _ in range(4):
        step, _ = put_both(engines, [7], [[cur]])
        cur = int(np.argmax(step[0]))
        ref.append(cur)
    flush_both(engines, [7])
    stream = _restore_cycle(engines, 7, tokens, lat, 4, first)
    assert stream == ref
    flush_both(engines, [7])


def test_chunked_restore_pipeline_matches_jax(weights):
    """One layer per replay chunk: begin_restore ships chunk 0 ahead and
    advance_restores(1) replays one chunk per call."""
    pair = make_pair(weights, hcache={"restore_chunk_layers": 1})
    je, te = pair
    rng = np.random.default_rng(6)
    tokens = [prompt(rng, 12), prompt(rng, 21)]
    logits, lat = put_both(pair, [1, 2], tokens)
    flush_both(pair, [1, 2])
    jt = je.begin_restore([1, 2], tokens, lat)
    tt = te.begin_restore([1, 2], tokens, [torch.tensor(x) for x in lat])
    assert te.pending_restore_chunks == je.pending_restore_chunks == 4
    assert te.restoring_uids == je.restoring_uids
    with pytest.raises(RuntimeError):
        te.put([1], [[3]])
    while not jt.done:
        assert te.advance_restores(1) == je.advance_restores(1)
        assert tt.done == jt.done
    assert te.restore_stats == je.restore_stats
    assert te.serialize() == je.serialize()
    put_both(pair, [1, 2], [[int(np.argmax(row))] for row in logits])


def test_abort_restore_frees_the_lane(engines):
    je, te = engines
    rng = np.random.default_rng(7)
    tokens = prompt(rng, 10)
    _, lat = put_both(engines, [3], [tokens])
    flush_both(engines, [3])
    je.begin_restore([3], [tokens], lat)
    te.begin_restore([3], [tokens], [torch.tensor(lat[0])])
    assert te.abort_restore(3) == je.abort_restore(3) == [3]
    assert te.serialize() == je.serialize()
    assert te.restoring_uids == []


def test_suspend_resume_matches_jax(engines):
    rng = np.random.default_rng(8)
    logits, _ = put_both(engines, [1], [prompt(rng, 18)])
    for e in engines:
        e.suspend_sequence(1)
    assert engines[1].serialize() == engines[0].serialize()
    with pytest.raises(RuntimeError):
        engines[1].put([1], [[1]])
    # another sequence takes the freed blocks meanwhile
    put_both(engines, [2], [prompt(rng, 20)])
    for e in engines:
        e.resume_sequence(1)
    assert engines[1].serialize() == engines[0].serialize()
    cur = int(np.argmax(logits[0]))
    for _ in range(3):
        step, _ = put_both(engines, [1, 2], [[cur], [cur]])
        cur = int(np.argmax(step[0]))
    flush_both(engines, [1, 2])


def test_scheduling_verdicts_match_jax(engines):
    je, te = engines
    for uids, lens in (([1, 2], [100, 100]), (list(range(9)), [1] * 9),
                       (list(range(5)), [1] * 5), ([1], [300]),
                       ([1], [64])):
        assert te.can_schedule(uids, lens).name == \
            je.can_schedule(uids, lens).name
    assert te.query(5, 1000, 1000) == je.query(5, 1000, 1000)
    prof_j, prof_t = je.restore_profile(), te.restore_profile()
    assert prof_t == prof_j


def test_latents_disabled(weights):
    _, _, tcfg, tparams = weights
    engine = InferenceEngineV2(
        tcfg, tparams, config=RaggedInferenceEngineConfig(
            **ENGINE_KW, hcache={"enable_latents": False}), device="cpu")
    logits, lat = engine.put([1], [[1, 2, 3]])
    assert lat == [None] and logits.shape == (1, 256)
