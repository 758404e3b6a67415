"""Ragged-batching inference engine with HCache KV restoration.

Counterpart of ``hcache_deepspeed_tpu/inference/engine_v2.py``
``InferenceEngineV2``. A ``put`` batch is routed into at most one batched
decode forward (all single-token continuations together: the ragged decode
batch, padded to a bucket of lanes) plus one bucketed prefill forward per
length bucket, with the JAX package's ``_bucket`` shapes, so both engines
make the same forwards and the same block allocations. Block 0 is reserved
as scratch for padded lanes.

``put`` returns CPU tensors: float32 logits ``[n, V]`` and per-sequence
latents ``[L, T, H]`` in the latent dtype. The engine runs on ``cuda``
unless ``device="cpu"`` is passed; with no GPU and no ``device`` it raises.
"""

import functools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..platform import annotate, available_memory, resolve_device
from ..utils.logging import log_dist
from .config import RaggedInferenceEngineConfig, torch_dtype
from .model import PagedInferenceModel
from .ragged.kv_cache import BlockedKVCache, StateManager
from .scheduling import SchedulingError, SchedulingResult


def _annotated(name):
    """Trace-annotate a serving entry point (a named range in profiler
    traces)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@dataclass
class RestoreTicket:
    """Handle for one ``begin_restore`` batch: ``done`` flips when
    every lane the batch staged has issued its last replay chunk (the
    sequences are then decodable)."""
    uids: List[int] = field(default_factory=list)
    pending: int = 0          # lanes still open
    done: bool = False


@dataclass
class _RestoreLane:
    """One bucket group's open restore pipeline + the state ops owed
    at completion."""
    pipe: object
    seqs: List[object]
    uids: List[int]
    ticket: RestoreTicket


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _sample_host(row, rng, temperature, top_k, top_p):
    """Host-side token sampler (greedy / temperature / top-k / nucleus)
    over one numpy logits row."""
    if temperature <= 0:
        return int(np.argmax(row))
    logits = row.astype(np.float64) / temperature
    k = min(top_k, len(logits))
    if k > 0:
        kth = np.partition(logits, -k)[-k]
        logits = np.where(logits < kth, -np.inf, logits)
    p = np.exp(logits - logits.max())
    p /= p.sum()
    if top_p < 1.0:
        # nucleus: smallest prob-sorted set with mass >= top_p
        order = np.argsort(p)[::-1]
        keep_sorted = np.cumsum(p[order]) - p[order] < top_p
        keep = np.zeros_like(p, dtype=bool)
        keep[order] = keep_sorted
        p = np.where(keep, p, 0.0)
        p /= p.sum()
    return int(rng.choice(len(p), p=p))


class InferenceEngineV2:

    def __init__(self, model_config, params,
                 config: RaggedInferenceEngineConfig = None, device=None):
        self.device = resolve_device(device)
        self.config = config or RaggedInferenceEngineConfig()
        sm_cfg = self.config.state_manager
        kv_cfg = self.config.kv_cache
        if self.config.quantization.enabled:
            raise NotImplementedError(
                "int8 weight quantization is not ported yet")
        if self.config.tensor_parallel != 1:
            raise NotImplementedError(
                "tensor-parallel serving is not ported yet")
        if sm_cfg.prefix_caching:
            raise NotImplementedError("prefix caching is not ported yet")

        self.block_size = kv_cfg.block_size
        self.max_context = min(sm_cfg.max_context,
                               model_config.max_positions)
        self.max_blocks_per_seq = -(-self.max_context // self.block_size)

        num_blocks = kv_cfg.num_blocks
        if num_blocks is None:
            # reserve mode, capped at what tracked sequences can ever use
            cap = sm_cfg.max_tracked_sequences * self.max_blocks_per_seq + 1
            num_blocks = min(self._size_cache_blocks(model_config, kv_cfg,
                                                     self.device), cap)
        self._model_config = model_config

        self.state = StateManager(sm_cfg.max_tracked_sequences,
                                  num_blocks, self.block_size,
                                  self.max_context)
        # block 0 is reserved scratch: padded lanes' tables point there
        self._scratch_block = self.state.allocator.allocate(1)[0]

        self.model = PagedInferenceModel(
            model_config, params, block_size=self.block_size,
            capture_latents=self.config.hcache.enable_latents,
            restore_chunk_layers=self.config.hcache.restore_chunk_layers,
            restore_chunk_bytes=self.config.hcache.restore_chunk_bytes,
            latent_dtype=self.config.hcache.latent_dtype,
            device=self.device)
        self.cache = BlockedKVCache(
            model_config.n_layer, num_blocks, self.block_size,
            model_config.n_kv_head, model_config.head_dim,
            dtype=torch_dtype(kv_cfg.cache_dtype), device=self.device)
        #: restore staging progress: cumulative counts of restore groups,
        #: sequences, chunk replays issued and latent bytes shipped
        #: host->device (counted when ISSUED, not when they land)
        self.restore_stats = {"restores": 0, "sequences": 0,
                              "chunks_issued": 0, "bytes_shipped": 0}
        #: open restore lanes (FIFO), advanced by advance_restores
        self._restore_lanes: List[_RestoreLane] = []
        log_dist(f"InferenceEngineV2: {num_blocks} KV blocks x "
                 f"{self.block_size} tokens, max_context="
                 f"{self.max_context}, device={self.device}", ranks=[0])

    @staticmethod
    def _size_cache_blocks(model_config, kv_cfg, device) -> int:
        """'reserve' allocation mode: size the pool from free device
        memory."""
        per_token = BlockedKVCache.token_bytes(
            model_config.n_layer, model_config.n_kv_head,
            model_config.head_dim, torch_dtype(kv_cfg.cache_dtype))
        free = available_memory(device)
        if free <= 0:          # unknown limit (the CPU)
            free = 1 << 30
        blocks = int(free * kv_cfg.memory_fraction /
                     (per_token * kv_cfg.block_size))
        return max(blocks, 16)

    # -------------------------------------------------------------- #
    # Scheduling API
    # -------------------------------------------------------------- #
    def query(self, uid: int, max_request_tokens: int,
              max_request_blocks: int) -> Tuple[int, int]:
        """Token/block budget for a request: how many tokens of this
        sequence could be scheduled and the blocks needed."""
        seq = self.state.get_sequence(uid)
        seen = seq.seen_tokens if seq else 0
        max_tokens = min(max_request_tokens, self.max_context - seen)
        blocks = self.state.blocks_needed(seq, max_tokens)
        return max_tokens, min(blocks, max_request_blocks)

    @property
    def free_blocks(self) -> int:
        return self.state.free_blocks

    def can_schedule(self, uids: Iterable[int],
                     lengths: Iterable[int]) -> SchedulingResult:
        uids, lengths = list(uids), list(lengths)
        sm = self.config.state_manager
        new_seqs = sum(1 for u in uids if self.state.get_sequence(u) is None)
        if self.state.n_tracked_sequences + new_seqs > \
                sm.max_tracked_sequences:
            return SchedulingResult.EngineSequenceLimitExceeded
        if len(uids) > sm.max_ragged_sequence_count:
            return SchedulingResult.BatchSequenceLimitExceeded
        # with chunked prefill each forward sees at most prefill_chunk
        # tokens per sequence, so the batch budget counts the chunk
        per_fwd = [min(n, sm.prefill_chunk) if sm.prefill_chunk else n
                   for n in lengths]
        if sum(per_fwd) > sm.max_ragged_batch_size:
            return SchedulingResult.BatchTokenLimitExceeded
        blocks = 0
        for uid, n in zip(uids, lengths):
            seq = self.state.get_sequence(uid)
            seen = seq.seen_tokens if seq else 0
            if seen + n > self.max_context:
                return SchedulingResult.SequenceTokenLimitExceeded
            blocks += self.state.blocks_needed(seq, n)
        if blocks > self.state.free_blocks:
            return SchedulingResult.KVCacheLimitExceeded
        return SchedulingResult.Success

    # -------------------------------------------------------------- #
    # put
    # -------------------------------------------------------------- #
    @_annotated("hds.serve.put")
    def put(self, batch_uids: Iterable[int], batch_tokens: Iterable,
            do_checks: bool = True):
        """One forward over a ragged batch. Returns ``(logits [n, V]
        float32, latents)`` on the CPU, where ``latents[i]`` is the
        sequence's ``[L, new_tokens, H]`` tensor (None when latent capture
        is disabled)."""
        batch_uids = list(batch_uids)
        batch_tokens = [np.asarray(t, np.int32).reshape(-1)
                        for t in batch_tokens]
        if do_checks:
            result = self.can_schedule(batch_uids,
                                       [len(t) for t in batch_tokens])
            if result != SchedulingResult.Success:
                raise SchedulingError(result)
        self._reject_suspended(batch_uids)

        # chunked prefill (Dynamic SplitFuse): run the leading chunks of
        # long prompts round by round, all sequences' chunk-k heads in ONE
        # forward, leaving tails <= chunk for the mixed batch below
        chunk = self.config.state_manager.prefill_chunk
        lead_latents: Dict[int, List] = {}
        if chunk:
            while True:
                long_idx = [i for i, t in enumerate(batch_tokens)
                            if len(t) > chunk]
                if not long_idx:
                    break
                heads: List = [None] * len(batch_tokens)
                for i in long_idx:
                    heads[i] = batch_tokens[i][:chunk]
                    seq = self.state.get_or_create_sequence(batch_uids[i])
                    self.state.maybe_allocate_kv(seq, chunk)
                    seq.pre_forward(chunk)
                part_l: List = [None] * len(batch_tokens)
                part_t: List = [None] * len(batch_tokens)
                self._run_prefill(batch_uids, heads, long_idx,
                                  _bucket(chunk), part_l, part_t)
                for i in long_idx:
                    self.state.get_sequence(batch_uids[i]).post_forward()
                    if self.config.hcache.enable_latents:
                        lead_latents.setdefault(i, []).append(part_t[i])
                    batch_tokens[i] = batch_tokens[i][chunk:]

        for uid, tokens in zip(batch_uids, batch_tokens):
            seq = self.state.get_or_create_sequence(uid)
            self.state.maybe_allocate_kv(seq, len(tokens))
            seq.pre_forward(len(tokens))

        # route: single-token continuations -> one batched decode;
        # everything else -> bucketed prefill
        decode_idx = [i for i, (u, t) in enumerate(
            zip(batch_uids, batch_tokens))
            if len(t) == 1 and self.state.get_sequence(u).seen_tokens > 0]
        decode_set = set(decode_idx)
        prefill_idx = [i for i in range(len(batch_uids))
                       if i not in decode_set]

        n = len(batch_uids)
        logits_out: List = [None] * n
        latents_out: List = [None] * n

        if decode_idx:
            self._run_decode(batch_uids, batch_tokens, decode_idx,
                             logits_out, latents_out)
        # prefills batch per length bucket: one forward per (B, T) bucket
        groups: Dict[int, List[int]] = {}
        for i in prefill_idx:
            groups.setdefault(_bucket(len(batch_tokens[i])), []).append(i)
        for T, idx in sorted(groups.items()):
            self._run_prefill(batch_uids, batch_tokens, idx, T,
                              logits_out, latents_out)

        for uid in batch_uids:
            self.state.get_sequence(uid).post_forward()

        if lead_latents:   # chunked prefill: stitch per-chunk latents
            for i, parts in lead_latents.items():
                tail = [latents_out[i]] if latents_out[i] is not None \
                    else []
                latents_out[i] = torch.cat(parts + tail, dim=1)

        return torch.stack(logits_out), latents_out

    def _tables(self, idx, uids):
        return np.stack([
            self.state.block_table(self.state.get_sequence(uids[i]),
                                   self.max_blocks_per_seq) for i in idx])

    def _blank_lanes(self, B, T=1):
        """Padded-lane scaffolding shared by every batched forward:
        zeroed tokens/start/t_len plus tables whose padded lanes point at
        the scratch block (t_len = 0, so nothing is written there)."""
        tok = np.zeros((B, T), np.int32)
        start = np.zeros((B,), np.int32)
        t_len = np.zeros((B,), np.int32)
        tables = np.zeros((B, self.max_blocks_per_seq), np.int32)
        tables[:, 0] = self._scratch_block
        return tok, start, t_len, tables

    def _run_decode(self, uids, tokens, idx, logits_out, latents_out):
        B = _bucket(len(idx))
        tok, start, t_len, tables = self._blank_lanes(B)
        tables[:len(idx)] = self._tables(idx, uids)
        for j, i in enumerate(idx):
            tok[j, 0] = tokens[i][0]
            start[j] = self.state.get_sequence(uids[i]).seen_tokens
            t_len[j] = 1
        with annotate("hds.serve.decode_dispatch"):
            logits, latents = self.model.forward_chunk(
                self.cache, tok, start, tables, t_len)
        logits = logits.cpu()
        if latents is not None:
            latents = latents.cpu()            # [L, B, 1, H]
        for j, i in enumerate(idx):
            logits_out[i] = logits[j]
            if latents is not None:
                latents_out[i] = latents[:, j]

    def _run_prefill(self, uids, tokens, idx, T, logits_out, latents_out):
        """One batched forward for all prefills in a length bucket;
        padded rows (t_len = 0) write nothing."""
        B = _bucket(len(idx), minimum=1)
        tok, start, t_len, tables = self._blank_lanes(B, T)
        tables[:len(idx)] = self._tables(idx, uids)
        for j, i in enumerate(idx):
            seq = self.state.get_sequence(uids[i])
            tok[j, :len(tokens[i])] = tokens[i]
            start[j] = seq.seen_tokens
            t_len[j] = len(tokens[i])
        with annotate("hds.serve.prefill_dispatch"):
            logits, latents = self.model.forward_chunk(
                self.cache, tok, start, tables, t_len)
        logits = logits.cpu()
        if latents is not None:
            latents = latents.cpu()            # [L, B, T, H]
        for j, i in enumerate(idx):
            logits_out[i] = logits[j]
            if latents is not None:
                latents_out[i] = latents[:, j, :len(tokens[i])]

    # -------------------------------------------------------------- #
    # Serving loop
    # -------------------------------------------------------------- #
    def generate(self, prompts, max_new_tokens: int = 32,
                 eos_token_id: int = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 return_logits: bool = False):
        """Batched prefill + ragged decode loop with continuous batching.

        ``prompts``: list of token-id lists. Greedy when temperature == 0,
        else softmax sampling (optionally top-k and/or nucleus top-p) from
        a numpy generator seeded with ``seed``. Returns the generated
        continuations (without the prompt), plus per-step logits when
        ``return_logits``. Sequences are flushed on completion.
        """
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        rng = np.random.default_rng(seed)
        base = max(self.state._seqs.keys(), default=-1) + 1
        uids = [base + i for i in range(len(prompts))]

        def sample(row):
            return _sample_host(row.numpy(), rng, temperature, top_k, top_p)

        outs = [[] for _ in prompts]
        logit_trace = [[] for _ in prompts]
        for p in prompts:
            if len(p) + max_new_tokens > self.max_context:
                raise SchedulingError(
                    SchedulingResult.SequenceTokenLimitExceeded)

        def need_blocks(i):
            """Whole-generation KV budget, committed at admission."""
            return -(-(len(prompts[i]) + max_new_tokens) //
                     self.block_size) + 1

        # every iteration admits whatever pending prompts still fit, then
        # runs ONE ragged put() mixing their prefills with the active
        # sequences' decodes; finished sequences flush mid-flight
        pending = list(range(len(prompts)))
        active: List[int] = []
        live: List[int] = []            # active + this step's admissions
        reserved: Dict[int, int] = {}   # admission-time block commitment
        cur: Dict[int, torch.Tensor] = {}
        headroom_changed = True
        try:
            while pending or active:
                admit = []
                if pending and headroom_changed:
                    held = sum(
                        reserved[i] - self.state.get_sequence(
                            uids[i]).cur_allocated_blocks - 1
                        for i in active)
                    blocks_left = self.state.allocator.free_blocks - held
                    for i in list(pending):
                        cand = admit + [i]
                        if need_blocks(i) > blocks_left:
                            continue
                        lens = [1] * len(active) + \
                            [len(prompts[j]) for j in cand]
                        uid_c = [uids[j] for j in active + cand]
                        if self.can_schedule(uid_c, lens) == \
                                SchedulingResult.Success:
                            admit.append(i)
                            blocks_left -= need_blocks(i)
                headroom_changed = bool(admit)
                if not active and not admit:
                    # nothing fits even alone: surface the verdict
                    i = pending[0]
                    result = self.can_schedule([uids[i]],
                                               [len(prompts[i])])
                    raise SchedulingError(
                        result if result != SchedulingResult.Success
                        else SchedulingResult.KVCacheLimitExceeded)

                step = active + admit
                live = step   # put() may allocate before raising
                toks = [[outs[i][-1]] for i in active] + \
                    [prompts[i] for i in admit]
                step_logits, _ = self.put([uids[i] for i in step], toks)
                for j, i in enumerate(step):
                    cur[i] = step_logits[j]
                for i in admit:
                    reserved[i] = need_blocks(i)
                pending = [i for i in pending if i not in admit]
                active = step

                finished = []
                for i in active:
                    tok = sample(cur[i])
                    outs[i].append(tok)
                    if return_logits:
                        logit_trace[i].append(cur[i])
                    if (eos_token_id is not None and
                            tok == eos_token_id) or \
                            len(outs[i]) >= max_new_tokens:
                        finished.append(i)
                for i in finished:
                    self.flush(uids[i])
                    reserved.pop(i, None)
                    headroom_changed = True
                active = [i for i in active if i not in finished]
        finally:
            for i in set(active) | set(live):
                if self.state.get_sequence(uids[i]) is not None:
                    self.flush(uids[i])
        if return_logits:
            return outs, [torch.stack(t) if t else None
                          for t in logit_trace]
        return outs

    # -------------------------------------------------------------- #
    # HCache restore
    # -------------------------------------------------------------- #
    @_annotated("hds.serve.restore_kv")
    def restore_kv(self, batch_uids: Iterable[int], batch_tokens: Iterable,
                   batch_latents: Iterable) -> None:
        """Rebuild the blocked KV cache for ``batch_uids`` from saved
        latents without a full forward: allocate blocks, then per chunk of
        layers replay the K/V projection + RoPE + cache write, with the
        next chunk's host->device copy overlapping the current replay.
        Runs :meth:`begin_restore` + :meth:`advance_restores` to
        completion."""
        self.begin_restore(batch_uids, batch_tokens, batch_latents)
        self.advance_restores()

    def begin_restore(self, batch_uids: Iterable[int],
                      batch_tokens: Iterable,
                      batch_latents: Iterable) -> RestoreTicket:
        """Open a restore lane: validate + admit the batch all-or-nothing,
        allocate KV blocks, build the pinned lane slabs and issue the
        first chunks' host->device copies, but replay nothing yet. Until
        :meth:`advance_restores` drains the lane, the sequences are
        tracked and in flight (their blocks are held; they must not be
        decoded)."""
        batch_uids = list(batch_uids)
        self._reject_suspended(batch_uids)
        items = []
        for uid, tokens, latents in zip(batch_uids, batch_tokens,
                                        batch_latents):
            if latents is None:
                continue
            tokens = np.asarray(tokens, np.int32).reshape(-1)
            latents = torch.as_tensor(latents)         # [L, T, H]
            if latents.shape[1] != len(tokens):
                raise ValueError(
                    f"uid {uid}: {len(tokens)} tokens but latents for "
                    f"{latents.shape[1]}")
            items.append((uid, tokens, latents))
        uid_list = [it[0] for it in items]
        if len(set(uid_list)) != len(uid_list):
            # grouped lanes read seen_tokens before any post_forward: a
            # duplicated uid would overwrite its own slots silently
            raise ValueError(f"duplicate uids in restore_kv: {uid_list}")
        # all-or-nothing admission: a mid-group failure would strand
        # earlier lanes with in-flight accounting and no KV
        new_seqs = sum(1 for uid in uid_list
                       if self.state.get_sequence(uid) is None)
        if self.state.n_tracked_sequences + new_seqs > \
                self.config.state_manager.max_tracked_sequences:
            raise SchedulingError(
                SchedulingResult.EngineSequenceLimitExceeded)
        need = 0
        for uid, tokens, _ in items:
            seq = self.state.get_sequence(uid)
            seen = seq.seen_tokens if seq else 0
            if seen + len(tokens) > self.max_context:
                raise SchedulingError(
                    SchedulingResult.SequenceTokenLimitExceeded)
            need += self.state.blocks_needed(seq, len(tokens))
        if need > self.state.free_blocks:
            raise SchedulingError(SchedulingResult.KVCacheLimitExceeded)
        groups: Dict[int, List] = {}
        for item in items:
            groups.setdefault(_bucket(len(item[1])), []).append(item)
        self.restore_stats["restores"] += 1
        self.restore_stats["sequences"] += len(items)

        def _progress(layer0, nbytes):
            self.restore_stats["chunks_issued"] += 1
            self.restore_stats["bytes_shipped"] += int(nbytes)

        ticket = RestoreTicket(uids=list(uid_list))
        for T, group in sorted(groups.items()):
            lat, start, t_len, tables, seqs = \
                self._stage_restore_group(group, T)
            pipe = self.model.restore_pipeline(
                self.cache, lat, start, tables, t_len,
                progress_cb=_progress)
            pipe.prefetch()   # chunk 0's copy starts now
            ticket.pending += 1
            self._restore_lanes.append(
                _RestoreLane(pipe=pipe, seqs=seqs,
                             uids=[it[0] for it in group], ticket=ticket))
        if ticket.pending == 0:
            ticket.done = True
        return ticket

    def advance_restores(self, max_chunks: int = 0):
        """Issue up to ``max_chunks`` chunk replays across the open restore
        lanes, oldest lane first (0 = drain everything). Returns
        ``(chunks_issued, completed_uids, touched_uids)``; a lane's
        sequences become decodable (their ``post_forward`` runs) exactly
        when its last chunk has been issued."""
        issued = 0
        completed: List[int] = []
        touched: List[int] = []
        while self._restore_lanes and (max_chunks <= 0 or
                                       issued < max_chunks):
            lane = self._restore_lanes[0]
            budget = 0 if max_chunks <= 0 else max_chunks - issued
            n = lane.pipe.advance(budget)
            issued += n
            if n:
                touched.extend(lane.uids)
            if not lane.pipe.done:
                break
            for seq in lane.seqs:
                seq.post_forward()
            completed.extend(lane.uids)
            lane.ticket.pending -= 1
            if lane.ticket.pending <= 0:
                lane.ticket.done = True
            self._restore_lanes.pop(0)
        return issued, completed, touched

    def abort_restore(self, uid: int) -> List[int]:
        """Abort the open restore lane holding ``uid``: every sequence the
        lane staged is flushed (its blocks and tracked slot free
        immediately). Returns the aborted uids ([] when no lane holds
        ``uid``). The caller's latents survive for a later retry."""
        for i, lane in enumerate(self._restore_lanes):
            if uid in lane.uids:
                self._restore_lanes.pop(i)
                lane.pipe.close()
                for u in lane.uids:
                    self.state.flush_sequence(u)
                lane.ticket.pending -= 1
                if lane.ticket.pending <= 0:
                    lane.ticket.done = True
                return list(lane.uids)
        return []

    @property
    def pending_restore_chunks(self) -> int:
        """Replay chunks not yet issued across all open lanes."""
        return sum(l.pipe.chunks_total - l.pipe.chunks_issued
                   for l in self._restore_lanes)

    @property
    def restoring_uids(self) -> List[int]:
        return [u for l in self._restore_lanes for u in l.uids]

    def restore_profile(self) -> Dict:
        """Static shape facts for the restore-vs-recompute crossover model:
        latent bytes per token, the replay/prefill FLOPs split, and the
        restore chunking."""
        cfg = self._model_config
        H = cfg.hidden_size
        kvd = cfg.n_kv_head * cfg.head_dim
        qd = cfg.n_head * cfg.head_dim
        # matmul flops per token per layer (factor 2 folded out)
        replay = H * (qd + 2 * kvd)
        full = replay + H * qd + 3 * H * cfg.intermediate_size
        return {
            "n_layer": cfg.n_layer,
            "latent_bytes_per_token": cfg.hidden_size
            * self.model.latent_dtype.itemsize * cfg.n_layer,
            "replay_flops_frac": replay / full,
            "restore_chunk_layers": self.model.restore_chunk_layers,
            "restore_chunk_bytes": self.model.restore_chunk_bytes,
        }

    def _stage_restore_group(self, group, T=None):
        """State ops + lane slab for ONE bucket group of
        ``(uid, tokens, latents)`` items: allocates KV, marks the
        sequences in flight (the caller ``post_forward()``s each returned
        seq once its replay is issued) and builds the padded latent slab
        ``[L, n, T, H]``, layer-major, directly in pinned host memory when
        the engine runs on the card."""
        if T is None:
            T = _bucket(max(len(it[1]) for it in group))
        n = _bucket(len(group), minimum=1)
        L, _, H = group[0][2].shape
        lat = torch.zeros((L, n, T, H), dtype=group[0][2].dtype,
                          pin_memory=self.device.type == "cuda")
        _, start, t_len, tables = self._blank_lanes(n)
        seqs = []
        for j, (uid, tokens, latents) in enumerate(group):
            seq = self.state.get_or_create_sequence(uid)
            self.state.maybe_allocate_kv(seq, len(tokens))
            seq.pre_forward(len(tokens))
            lat[:, j, :len(tokens)] = latents
            start[j] = seq.seen_tokens
            t_len[j] = len(tokens)
            tables[j] = self.state.block_table(
                seq, self.max_blocks_per_seq)
            seqs.append(seq)
        return lat, start, t_len, tables, seqs

    # -------------------------------------------------------------- #
    # Lifecycle
    # -------------------------------------------------------------- #
    def flush(self, uid: int) -> None:
        if self._restore_lanes and uid in self.restoring_uids:
            raise RuntimeError(
                f"sequence {uid} has an open restore lane; its blocks "
                "cannot be freed while replay chunks are in flight")
        self.state.flush_sequence(uid)

    # -------------------------------------------------------------- #
    # Host offload of a sequence's exact KV (suspend/resume): unlike
    # HCache restore, no replay; the continuation is bit-identical.
    # -------------------------------------------------------------- #
    def _reject_suspended(self, uids):
        """Both cache write paths (put, restore_kv) refuse suspended
        sequences and sequences whose restore lane is still open, before
        any allocation or bookkeeping."""
        restoring = set(self.restoring_uids) if self._restore_lanes \
            else ()
        for uid in uids:
            if uid in restoring:
                raise RuntimeError(
                    f"sequence {uid} has an open restore lane; drain "
                    "advance_restores before forwarding it")
            seq = self.state.get_sequence(uid)
            if seq is not None and seq.host_kv is not None:
                raise RuntimeError(
                    f"sequence {uid} is suspended (KV on host); call "
                    "resume_sequence first")

    def _token_slots(self, seq, n):
        """Flat pool indices of the sequence's first n token slots."""
        t = np.arange(n)
        blocks = np.asarray(seq.blocks, np.int64)
        slots = blocks[t // self.block_size] * self.block_size + \
            t % self.block_size
        return torch.from_numpy(slots).to(self.device)

    def suspend_sequence(self, uid: int) -> None:
        """Copy the sequence's KV to host memory and free its pool
        blocks. The sequence stays tracked; ``resume_sequence`` swaps it
        back in (possibly into different blocks)."""
        seq = self.state.get_sequence(uid)
        if seq is None:
            raise KeyError(f"unknown sequence {uid}")
        if seq.host_kv is not None:
            return   # already suspended
        idx = self._token_slots(seq, seq.seen_tokens)
        seq.host_kv = (self.cache.k.index_select(2, idx).cpu(),
                       self.cache.v.index_select(2, idx).cpu())
        if seq.blocks:
            self.state.allocator.free(seq.blocks)
            seq.blocks = []

    def resume_sequence(self, uid: int) -> None:
        seq = self.state.get_sequence(uid)
        if seq is None:
            raise KeyError(f"unknown sequence {uid}")
        if seq.host_kv is None:
            return   # not suspended
        need = self.state.blocks_needed(seq, 0)
        if need > self.state.free_blocks:
            raise SchedulingError(SchedulingResult.KVCacheLimitExceeded)
        self.state.maybe_allocate_kv(seq, 0)
        host_k, host_v = seq.host_kv
        seq.host_kv = None
        if seq.seen_tokens == 0:
            return
        idx = self._token_slots(seq, seq.seen_tokens)
        # in place: no second full-size pool is allocated
        self.cache.k.index_copy_(2, idx, host_k.to(self.device,
                                                   self.cache.k.dtype))
        self.cache.v.index_copy_(2, idx, host_v.to(self.device,
                                                   self.cache.v.dtype))

    def serialize(self) -> Dict:
        """Host-side engine state."""
        return {
            "sequences": {
                uid: {"seen_tokens": s.seen_tokens, "blocks": list(s.blocks)}
                for uid, s in self.state._seqs.items()
            },
            "free_blocks": self.state.free_blocks,
        }
