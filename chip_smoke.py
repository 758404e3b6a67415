#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the time to build the kernels from ``ops/csrc``;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, with its time, the plain version's, one PyTorch library
   call's (a yardstick the port never calls) and the least time the card
   could take (``bound_ms``);
3. main path: ``InferenceEngineV2`` at Llama-2-7B widths and depth with
   random bf16 weights from a seed: one ragged prefill of 4 prompts, 32
   greedy decode steps, then flush -> ``restore_kv`` -> decode of one
   sequence from its latents, checked against the sequence that was never
   flushed. Every kernel's launch counter must have grown in this phase.

Then a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and prints no result. It needs CUDA; without
it, or without the package beside it, it fails.
"""

import json
import math
import sys
import time

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, 700 W

PA_TOL = 2e-2                       # max |kernel - plain|, O(1) inputs
RMS_REL_TOL = 2.0 ** -7             # one bf16 ulp, relative
#: restored K/V vs the prefill's: a few bf16 ulps of the largest value
#: (the replay's projections run at other batch shapes than the prefill's
#: and decode's, so their fp32 sums may round to a neighbouring bf16)
KV_REL_TOL = 2.0 ** -5


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean time of one eager ``fn()`` call in ms, from CUDA events around
    back-to-back calls: device time, or the host's launch time where that
    is longer (small kernels)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _device_events(prof):
    """The kernels, copies and memsets of a profile (no annotations). The
    profiler has been seen to miss kernels of a run, so these feed only
    the phase breakdowns; kernel times come from ``graph_ms``."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("hds.")]


def graph_ms(fn, iters=20, warmup=3):
    """Mean device time of one ``fn()`` call in ms: ``iters`` calls are
    captured in one CUDA graph, and one replay is timed with CUDA events,
    so host launch time does not count."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ #
# paged attention
# ------------------------------------------------------------------ #
def pa_inputs(B, T, G, KV, D, BS, starts, lens, seed, dtype):
    """Random O(1) inputs on the card; each sequence's blocks are a
    shuffled, disjoint slice of a pool with 8 blocks to spare."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    NB = max(1, max(-(-n // BS) for n in lens))
    nblk = B * NB + 8
    q = torch.randn(B, T, KV * G, D, generator=g, device=dev).to(dtype)
    kp = torch.randn(KV, nblk * BS, D, generator=g, device=dev).to(dtype)
    vp = torch.randn(KV, nblk * BS, D, generator=g, device=dev).to(dtype)
    perm = torch.randperm(nblk, generator=g, device=dev)[:B * NB]
    tables = perm.reshape(B, NB).to(torch.int32).contiguous()
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, start, kv_len


def pa_work(q, kp, tables, start, kv_len):
    """Bytes the function must move and the operations it does on these
    inputs: the valid K/V rows of each sequence are read once."""
    B, T, Hq, D = q.shape
    KV = kp.shape[0]
    it = q.element_size()
    lens = kv_len.tolist()
    starts = start.tolist()
    nbytes = 2 * q.numel() * it + 4 * (tables.numel() + 2 * B)
    nbytes += sum(2 * KV * n * D * it for n in lens)
    ops = 0
    for b in range(B):
        for t in range(T):
            cols = max(0, min(lens[b], starts[b] + t + 1))
            ops += Hq * cols * 4 * D            # q.k and p.v, 2 ops each
    return nbytes, ops


def pa_library_fn(q, kp, vp, tables, start, kv_len, BS):
    """F.scaled_dot_product_attention over the gathered K/V (the gather
    and GQA expansion are done once, outside the timed call)."""
    import torch
    import torch.nn.functional as F
    B, T, Hq, D = q.shape
    KV = kp.shape[0]
    S = tables.shape[1] * BS
    pos = torch.arange(S, device=q.device)
    slots = tables.long()[:, pos // BS] * BS + pos % BS          # [B, S]
    k = kp[:, slots].permute(1, 0, 2, 3).repeat_interleave(Hq // KV, 1)
    v = vp[:, slots].permute(1, 0, 2, 3).repeat_interleave(Hq // KV, 1)
    qpos = start.long()[:, None] + torch.arange(T, device=q.device)
    mask = (pos[None, None] <= qpos[:, :, None]) & \
        (pos[None, None] < kv_len.long()[:, None, None])        # [B, T, S]
    qh = q.transpose(1, 2).contiguous()
    k, v, mask = k.contiguous(), v.contiguous(), mask[:, None]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def check_paged_attention(name, B, T, G, KV, D, BS, starts, lens, seed,
                          iters=20):
    import torch

    from hcache_deepspeed_tpu_torch.ops import paged_attention as pa
    args = pa_inputs(B, T, G, KV, D, BS, starts, lens, seed,
                     torch.bfloat16)
    out = pa.cuda_paged_attention(*args, BS)
    ref = pa.reference_paged_attention(*args, BS)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not math.isfinite(err) or err > PA_TOL:
        raise AssertionError(f"paged attention {name}: max|diff| {err} > "
                             f"{PA_TOL}")
    nbytes, ops = pa_work(args[0], args[1], args[3], args[4], args[5])
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    res = {"phase": "kernel", "kernel": "paged_attention", "case": name,
           "B": B, "T": T, "G": G, "KV": KV, "D": D, "BS": BS,
           "kv_len": lens, "start": starts, "max_abs_err": err,
           "tol": PA_TOL,
           "kernel_ms": graph_ms(
               lambda: pa.cuda_paged_attention(*args, BS), iters),
           "plain_ms": graph_ms(
               lambda: pa.reference_paged_attention(*args, BS), iters),
           "library_ms": graph_ms(pa_library_fn(*args, BS), iters),
           "kernel_call_ms": cuda_ms(
               lambda: pa.cuda_paged_attention(*args, BS), iters),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops}
    emit(res)
    return res


def phase_paged_attention():
    import torch
    g = torch.Generator().manual_seed(7)
    # ragged decode contexts 0..2048, one empty lane
    lens = [0, 2048] + torch.randint(1, 2049, (6,), generator=g).tolist()
    results = []
    for G, KV in ((1, 32), (4, 8)):          # Llama-2-7B, Llama-3-8B
        for BS in (16, 64):
            results.append(check_paged_attention(
                f"decode_G{G}_BS{BS}", 8, 1, G, KV, 128, BS,
                [max(n - 1, 0) for n in lens], lens, seed=1))
            for st in (0, 256):
                results.append(check_paged_attention(
                    f"prefill_G{G}_BS{BS}_start{st}", 1, 512, G, KV, 128,
                    BS, [st], [st + 512], seed=2))
    return results


# ------------------------------------------------------------------ #
# RMSNorm
# ------------------------------------------------------------------ #
def check_rms_norm(N, H=4096, iters=50, seed=3):
    import torch
    import torch.nn.functional as F

    from hcache_deepspeed_tpu_torch.ops import rms_norm as rn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, H, generator=g, device=dev).to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(H, generator=g, device=dev)).to(
        torch.bfloat16)
    eps = 1e-5
    out = rn.cuda_rms_norm(x, w, eps)
    ref = rn.reference_rms_norm(x, w, eps)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    rel = (diff / ref.float().abs().clamp_min(1e-30)).max().item()
    if not math.isfinite(rel) or rel > RMS_REL_TOL:
        raise AssertionError(f"rms_norm N={N}: relative diff {rel} > "
                             f"{RMS_REL_TOL}")
    nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
    b_ms, b_by = bound(nbytes, 4 * x.numel(), "bfloat16")
    res = {"phase": "kernel", "kernel": "rms_norm", "case": f"N{N}_H{H}",
           "N": N, "H": H, "max_abs_err": diff.max().item(),
           "max_rel_err": rel, "tol_rel": RMS_REL_TOL,
           "kernel_ms": graph_ms(lambda: rn.cuda_rms_norm(x, w, eps),
                                  iters),
           "plain_ms": graph_ms(lambda: rn.reference_rms_norm(x, w, eps),
                                 iters),
           "library_ms": graph_ms(lambda: F.rms_norm(x, (H,), w, eps),
                                   iters),
           "kernel_call_ms": cuda_ms(lambda: rn.cuda_rms_norm(x, w, eps),
                                     iters),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    emit(res)
    return res


def phase_rms_norm():
    return [check_rms_norm(N) for N in (8, 512)]


# ------------------------------------------------------------------ #
# device
# ------------------------------------------------------------------ #
def phase_device():
    import torch

    from hcache_deepspeed_tpu_torch.ops import _build
    from hcache_deepspeed_tpu_torch.platform import device_report
    smi = device_report()
    t0 = time.perf_counter()
    _build.load_library()
    res = {"phase": "device", "nvidia_smi": smi,
           "name": torch.cuda.get_device_name(0),
           "capability": list(torch.cuda.get_device_capability(0)),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "build_s": time.perf_counter() - t0,
           "build_dir": _build.build_info["dir"]}
    emit(res)
    return res


# ------------------------------------------------------------------ #
# main path: Llama-2-7B serving with HCache restore
# ------------------------------------------------------------------ #
PROMPT_LENS = (512, 384, 200, 64)
DECODE_STEPS = 32
BLOCK_SIZE = 64
NUM_BLOCKS = 256            # 256 x 64 tokens x 0.5 MiB/token = 8 GiB of KV
RESTORE_CHUNK_LAYERS = 8    # 4 replay chunks: the ship lane runs ahead


def _device_profile(fn):
    """Run ``fn`` once under torch.profiler. Returns (its result, the
    device's busy ms (union of kernel and copy intervals), the window from
    the first device op's start to the last one's end, the 6 kernels with
    the most device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in _device_events(prof))
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (max(e0 for _, e0 in spans) - spans[0][0]) if spans else 0.0
    by_name = {}
    for e in _device_events(prof):
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return out, busy / 1e3, window / 1e3, [
        {"kernel": k[:80], "ms": ms, "calls": n} for k, (ms, n) in top]


def _margin(row):
    top = row.topk(2).values
    return float(top[0] - top[1])


def phase_main_path(cfg, device="cuda", prompt_lens=PROMPT_LENS,
                    decode_steps=DECODE_STEPS, num_blocks=NUM_BLOCKS):
    """Prefill -> decode -> flush -> restore_kv -> decode through the
    engine. Returns the phase's numbers, with the launch counts of this
    run only. (``device="cpu"`` and a small ``cfg`` rehearse it on the
    host with the plain versions.)"""
    import torch

    from hcache_deepspeed_tpu_torch import ops
    from hcache_deepspeed_tpu_torch.inference import (
        InferenceEngineV2, RaggedInferenceEngineConfig)
    from hcache_deepspeed_tpu_torch.models.llama import random_params
    from hcache_deepspeed_tpu_torch.platform import synchronize
    t0 = time.perf_counter()
    engine = InferenceEngineV2(
        cfg, random_params(cfg, seed=0, device=device),
        config=RaggedInferenceEngineConfig(
            state_manager={"max_tracked_sequences": 16,
                           "max_ragged_batch_size": 2048,
                           "max_ragged_sequence_count": 16},
            kv_cache={"block_size": BLOCK_SIZE, "num_blocks": num_blocks,
                      "cache_dtype": "bfloat16"},
            hcache={"restore_chunk_layers": RESTORE_CHUNK_LAYERS}),
        device=device)
    dev = engine.device
    g = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in prompt_lens]
    # warm-up outside the measured run (library handles, allocator)
    engine.put([100], [prompts[3][:16]])
    engine.put([100], [[1]])
    engine.flush(100)
    synchronize(dev)
    setup_s = time.perf_counter() - t0

    uids = list(range(len(prompts)))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, latents = engine.put(uids, prompts)
    prefill_s = time.perf_counter() - t0
    if logits.shape != (len(uids), cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or misshapen")
    for lat, n in zip(latents, prompt_lens):
        if lat.shape != (cfg.n_layer, n, cfg.hidden_size) or \
                lat.dtype != cfg.compute_dtype:
            raise AssertionError(f"latents {tuple(lat.shape)} {lat.dtype}")
    prefill_counts = ops.launch_counts()

    hist = {u: [latents[u]] for u in uids}
    fed = {u: [] for u in uids}
    toks = [int(row.argmax()) for row in logits]
    step_ms = []
    for _ in range(decode_steps):
        t0 = time.perf_counter()
        logits, lat = engine.put(uids, [[x] for x in toks])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(logits).all():
            raise AssertionError("decode logits not finite")
        for u in uids:
            hist[u].append(lat[u])
            fed[u].append(toks[u])
        toks = [int(row.argmax()) for row in logits]

    # the never-flushed reference: one more decode step of every lane;
    # the check runs on the lane with the widest top-2 margin, so a
    # near-tie of random weights cannot decide it
    def ref_step():
        return engine.put(uids, [[x] for x in toks])
    profiled = {}
    if dev.type == "cuda":     # where one decode step's time goes
        (ref_logits, _), busy_ms, window_ms, top = _device_profile(
            ref_step)
        profiled = {"profiled_step_device_busy_ms": busy_ms,
                    "profiled_step_device_window_ms": window_ms,
                    "profiled_step_device_idle_share":
                        1.0 - busy_ms / window_ms if window_ms else None,
                    "profiled_step_top_kernels": top}
    else:
        ref_logits, _ = ref_step()
    u = max(uids, key=lambda i: _margin(ref_logits[i]))
    tokens = prompts[u] + fed[u]
    lat_u = torch.cat(hist[u], dim=1)                    # [L, N, H]
    n_tok = len(tokens)
    slots = engine._token_slots(engine.state.get_sequence(u), n_tok)
    k_before = engine.cache.k.index_select(2, slots)
    v_before = engine.cache.v.index_select(2, slots)

    engine.flush(u)
    synchronize(dev)
    t0 = time.perf_counter()
    engine.restore_kv([u], [tokens], [lat_u])
    synchronize(dev)
    restore_s = time.perf_counter() - t0
    slots = engine._token_slots(engine.state.get_sequence(u), n_tok)
    kv_err = max(
        (engine.cache.k.index_select(2, slots).float()
         - k_before.float()).abs().max().item(),
        (engine.cache.v.index_select(2, slots).float()
         - v_before.float()).abs().max().item())
    kv_scale = max(k_before.float().abs().max().item(),
                   v_before.float().abs().max().item())
    if not kv_err <= KV_REL_TOL * kv_scale:
        raise AssertionError(f"restored K/V differ by {kv_err} > "
                             f"{KV_REL_TOL} x {kv_scale}")
    after, _ = engine.put([u], [[toks[u]]])
    nxt_ref, nxt = int(ref_logits[u].argmax()), int(after[0].argmax())
    logit_err = (after[0] - ref_logits[u]).abs().max().item()
    if nxt != nxt_ref:
        raise AssertionError(f"next greedy token after restore {nxt} != "
                             f"{nxt_ref} without the flush")
    counts = ops.launch_counts()
    if dev.type == "cuda":
        # after the counted run: the same prefill again, profiled, to see
        # where its time goes (the profiler slows the host, so prefill_s
        # above comes from the unprofiled run)
        extra = [u + 10 for u in uids]
        _, busy_ms, window_ms, top = _device_profile(
            lambda: engine.put(extra, prompts))
        for x in extra:
            engine.flush(x)
        profiled.update({
            "profiled_prefill_device_busy_ms": busy_ms,
            "profiled_prefill_device_window_ms": window_ms,
            "profiled_prefill_device_idle_share":
                1.0 - busy_ms / window_ms if window_ms else None,
            "profiled_prefill_top_kernels": top})
    res = {"phase": "main_path", "device": str(dev),
           "hidden": cfg.hidden_size, "depth": cfg.n_layer,
           "weights": f"random {cfg.dtype}, seed 0",
           "block_size": BLOCK_SIZE,
           "num_blocks": num_blocks, "prompt_lens": list(prompt_lens),
           "setup_s": setup_s, "prefill_s": prefill_s,
           "prefill_tokens_per_s": sum(prompt_lens) / prefill_s,
           "decode_steps": decode_steps, "decode_lanes": len(uids),
           "decode_ms_per_step_mean": sum(step_ms) / len(step_ms),
           "decode_ms_per_step_median": sorted(step_ms)[len(step_ms) // 2],
           "restore_uid": u, "restore_tokens": n_tok,
           "restore_ms": restore_s * 1e3,
           "latent_bytes": lat_u.numel() * lat_u.element_size(),
           "restore_chunk_layers": engine.model.restore_chunk_layers,
           "restore_stats": engine.restore_stats,
           "restored_kv_max_abs_err": kv_err, "kv_abs_max": kv_scale,
           "next_token_after_restore": nxt, "next_token_reference": nxt_ref,
           "top2_margin": _margin(ref_logits[u]),
           "logits_max_abs_err_after_restore": logit_err,
           "launches_prefill": prefill_counts,
           "launches": counts, **profiled}
    if dev.type == "cuda":
        res["max_memory_allocated_gib"] = \
            torch.cuda.max_memory_allocated(dev) / 2**30
    emit(res)
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = phase_device()
    rms = phase_rms_norm()
    pa = phase_paged_attention()
    from hcache_deepspeed_tpu_torch.models.llama import llama2_7b
    main_res = phase_main_path(llama2_7b())
    if any(n == 0 for n in main_res["launches"].values()):
        raise AssertionError("a kernel of the main path never launched: "
                             f"{main_res['launches']}")
    # each kernel at the main path's decode shapes: Llama-2-7B, the 4
    # lanes of the last decode step in a bucket of 8 (4 empty), block 64
    lens = [n + DECODE_STEPS for n in PROMPT_LENS] + [0] * 4
    pa_main = check_paged_attention(
        "main_path_decode", 8, 1, 1, 32, 128, BLOCK_SIZE,
        [max(n - 1, 0) for n in lens], lens, seed=4)
    rms_main = check_rms_norm(8, seed=5)
    from hcache_deepspeed_tpu_torch.ops import kernel_ops
    rows = []
    for op, r in (("paged_attention", pa_main), ("rms_norm", rms_main)):
        k = kernel_ops()[op]
        rows.append({"name": op, "route": "cuda", "source": k.source,
                     "replaces": k.replaces,
                     "launches": main_res["launches"][op],
                     "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "kernel_cases": len(rms) + len(pa)})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
