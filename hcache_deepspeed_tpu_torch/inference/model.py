"""Paged-KV inference model for the Llama family, with HCache latents.

Counterpart of ``hcache_deepspeed_tpu/inference/model.py``
``PagedInferenceModel``:

``forward_chunk(cache, tokens[B,T], start[B], tables[B,NB], t_len[B])``
    processes T new tokens for each of B sequences against the paged cache
    (T = 1: a ragged decode batch; T = bucket: prefill, including chunked
    continuation since ``start`` offsets positions). Per layer: RMSNorm
    (the latent is this output), QKV + RoPE, the K/V scatter into the
    pool, paged attention, o-projection, RMSNorm, SwiGLU MLP. Returns
    fp32 logits of each lane's last valid token and the latents
    ``[L, B, T, H]``.

``restore_kv`` / :class:`RestorePipeline`
    the HCache delta: rebuild a sequence's KV from saved latents by
    replaying only the K/V projection + RoPE + cache write, a chunk of
    layers at a time, with the next chunk's latents copied host->device on
    a copy stream while the current chunk replays.

Weights keep the JAX ``[in, out]`` layout and go through ``torch.matmul``
(plain products that the JAX package also left to its compiler). RMSNorm
and paged attention go through ``ops``: the CUDA kernels on the card, their
plain versions on the CPU.

Padded lanes: the JAX package scatters with ``mode="drop"`` at an
out-of-range index. Here the host computes the valid (row, pool slot)
pairs of each batch once, so padded tokens are filtered out before any
``index_copy_`` and never land in a live block or the scratch block.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.llama import LlamaConfig
from ..ops.paged_attention import paged_attention
from ..ops.rms_norm import rms_norm
from ..ops.rope import apply_rope, rope_frequencies
from ..platform import annotate
from .config import torch_dtype

_LATENT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: chunks shipped ahead of the replay (2: the classic double buffer)
_SHIP_DEPTH = 2


@dataclass
class BatchIndices:
    """One ragged batch's indices on the device, built once per forward
    (or restore) from the host-side block tables."""
    tokens: torch.Tensor      # [B, T] int64 (empty for a restore)
    rope_pos: torch.Tensor    # [B, T] int64 positions, clamped to the table
    rows: torch.Tensor        # [N] int64 flat b*T+t of the valid tokens
    slots: torch.Tensor       # [N] int64 pool slot of each valid token
    last: torch.Tensor        # [B] int64 flat index of each lane's last token
    tables: torch.Tensor      # [B, NB] int32
    start: torch.Tensor       # [B] int32
    kv_len: torch.Tensor      # [B] int32 = start + t_len


def batch_indices(tokens, start, tables, t_len, T, block_size,
                  max_positions, device) -> BatchIndices:
    """Host arithmetic of ``_trunk``/``_restore_layer`` (positions, the
    valid-token mask, flat pool slots), uploaded in two copies."""
    start = np.asarray(start, np.int64)
    t_len = np.asarray(t_len, np.int64)
    tables = np.asarray(tables, np.int32)
    B = start.shape[0]
    offs = np.arange(T)
    positions = start[:, None] + offs[None, :]                   # [B, T]
    b_idx, t_idx = np.nonzero(offs[None, :] < t_len[:, None])
    pos = positions[b_idx, t_idx]
    slots = tables[b_idx, pos // block_size].astype(np.int64) * \
        block_size + pos % block_size
    rows = b_idx * T + t_idx
    rope_pos = np.minimum(positions, max_positions - 1)
    last = np.arange(B) * T + np.maximum(t_len - 1, 0)
    tok = np.zeros((0,), np.int64) if tokens is None else \
        np.asarray(tokens, np.int64).reshape(-1)
    longs = [tok, rope_pos.reshape(-1), rows, slots, last]
    ints = [tables.reshape(-1), start.astype(np.int32),
            (start + t_len).astype(np.int32)]
    dl = torch.from_numpy(np.concatenate(longs)).to(device).split(
        [a.size for a in longs])
    di = torch.from_numpy(np.concatenate(ints)).to(device).split(
        [a.size for a in ints])
    return BatchIndices(
        tokens=dl[0].view(B, -1), rope_pos=dl[1].view(B, T), rows=dl[2],
        slots=dl[3], last=dl[4], tables=di[0].view(tables.shape),
        start=di[1], kv_len=di[2])


def _weight(x, dtype, device):
    return nn.Parameter(torch.as_tensor(x).to(device=device, dtype=dtype),
                        requires_grad=False)


class LlamaLayer(nn.Module):
    """One decoder layer's weights, JAX layout (kernels ``[in, out]``)."""

    def __init__(self, lp, dtype, device):
        super().__init__()
        sa, mlp = lp["self_attn"], lp["mlp"]
        self.input_layernorm = _weight(lp["input_layernorm"]["weight"],
                                       dtype, device)
        self.post_attention_layernorm = _weight(
            lp["post_attention_layernorm"]["weight"], dtype, device)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, _weight(sa[name]["kernel"], dtype, device))
        for name in ("gate_proj", "up_proj", "down_proj"):
            setattr(self, name, _weight(mlp[name]["kernel"], dtype, device))


class PagedInferenceModel(nn.Module):
    """Paged-attention Llama consuming the JAX ``LlamaForCausalLM`` param
    layout (``inference.convert.params_from_jax`` or
    ``models.llama.random_params``)."""

    def __init__(self, cfg: LlamaConfig, params, *, block_size: int,
                 capture_latents: bool = True,
                 restore_chunk_layers: int = 0,
                 restore_chunk_bytes: int = 64 * 1024 * 1024,
                 latent_dtype: str = "", device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.block_size = block_size
        self.capture_latents = capture_latents
        self.restore_chunk_layers = restore_chunk_layers
        self.restore_chunk_bytes = restore_chunk_bytes
        self.compute_dtype = cfg.compute_dtype
        # "" => capture in the compute dtype (bit-exact restore)
        self.latent_dtype = torch_dtype(latent_dtype) if latent_dtype \
            else self.compute_dtype
        if self.latent_dtype not in _LATENT_DTYPES:
            raise NotImplementedError(
                f"latent_dtype {latent_dtype!r} is not ported yet "
                "(float32, bfloat16 or float16)")
        self.n_layers = cfg.n_layer
        self.tied = cfg.tie_word_embeddings
        self.load_params(params)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_positions,
                                    cfg.rope_theta, device=self.device)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def load_params(self, params):
        """JAX-layout params -> this module's weights, cast to the compute
        dtype on the model's device."""
        dt, dev = self.compute_dtype, self.device
        self.embed = _weight(params["embed_tokens"]["embedding"], dt, dev)
        self.norm = _weight(params["norm"]["weight"], dt, dev)
        self.lm_head = None if self.tied else _weight(
            params["lm_head"]["kernel"], dt, dev)
        self.layers = nn.ModuleList(
            LlamaLayer(params[f"layers_{i}"], dt, dev)
            for i in range(self.cfg.n_layer))

    def _indices(self, tokens, start, tables, t_len, T) -> BatchIndices:
        return batch_indices(tokens, start, tables, t_len, T,
                             self.block_size, self.cfg.max_positions,
                             self.device)

    # -------------------------------------------------------------- #
    # Layer math (mirrors the JAX PagedInferenceModel, casts written out)
    # -------------------------------------------------------------- #
    def _kv(self, lp, h, positions):
        """h: [B, T, H] -> roped k, v [B, T, KV, D]."""
        B, T, _ = h.shape
        D = self.cfg.head_dim
        k = torch.matmul(h, lp.k_proj).view(B, T, -1, D)
        v = torch.matmul(h, lp.v_proj).view(B, T, -1, D)
        return apply_rope(k, self.cos, self.sin, positions), v

    def _qkv(self, lp, h, positions):
        """h: [B, T, H] -> q [B, T, Hq, D], k/v [B, T, KV, D] (roped)."""
        B, T, _ = h.shape
        q = torch.matmul(h, lp.q_proj).view(B, T, -1, self.cfg.head_dim)
        q = apply_rope(q, self.cos, self.sin, positions)
        k, v = self._kv(lp, h, positions)
        return q, k, v

    @staticmethod
    def _scatter_kv(ck, cv, k, v, idx: BatchIndices):
        """ck/cv: one layer's pool [KV, P, D], updated in place; k/v:
        [B, T, KV, D]. Only the valid tokens (``idx.rows``) are written,
        each to its own slot (``idx.slots``)."""
        KV, D = k.shape[2], k.shape[3]
        kt = k.reshape(-1, KV, D).index_select(0, idx.rows).transpose(0, 1)
        vt = v.reshape(-1, KV, D).index_select(0, idx.rows).transpose(0, 1)
        ck.index_copy_(1, idx.slots, kt.to(ck.dtype))
        cv.index_copy_(1, idx.slots, vt.to(cv.dtype))

    def _paged_attention(self, q, ck, cv, idx: BatchIndices):
        """q: [B, T, Hq, D] -> [B, T, Hq * D]."""
        B, T, Hq, D = q.shape
        out = paged_attention(q, ck, cv, idx.tables, idx.start, idx.kv_len,
                              self.block_size)
        return out.reshape(B, T, Hq * D)

    def _layer_step(self, x, lp, ck, cv, idx: BatchIndices,
                    latent_out: Optional[torch.Tensor]):
        cd, eps = self.compute_dtype, self.cfg.rms_norm_eps
        h = rms_norm(x, lp.input_layernorm, eps).to(cd)
        if latent_out is not None:
            latent_out.copy_(h)            # cast to the latent dtype
        q, k, v = self._qkv(lp, h, idx.rope_pos)
        # the scatter comes before attention reads the pool
        self._scatter_kv(ck, cv, k, v, idx)
        attn = self._paged_attention(q, ck, cv, idx)
        x = x + torch.matmul(attn, lp.o_proj)
        h2 = rms_norm(x, lp.post_attention_layernorm, eps).to(cd)
        x = x + self._mlp_out(lp, h2)
        return x.to(cd)

    @staticmethod
    def _mlp_out(lp, h2):
        """SwiGLU MLP on the post-attention hidden states."""
        gate = torch.matmul(h2, lp.gate_proj)
        up = torch.matmul(h2, lp.up_proj)
        return torch.matmul(F.silu(gate) * up, lp.down_proj)

    def _trunk(self, cache, idx: BatchIndices):
        """Embed -> layers. Returns (x [B, T, H], latents [L, B, T, H] or
        None); the final norm is applied by the caller to the rows it
        needs (it is row-wise, so this equals norming every row)."""
        x = self._embed_lookup(idx.tokens)
        B, T, H = x.shape
        latents = torch.empty((self.n_layers, B, T, H),
                              dtype=self.latent_dtype, device=self.device) \
            if self.capture_latents else None
        for layer, lp in enumerate(self.layers):
            x = self._layer_step(
                x, lp, cache.k[layer], cache.v[layer], idx,
                None if latents is None else latents[layer])
        return x, latents

    def _final_norm(self, x):
        return rms_norm(x, self.norm, self.cfg.rms_norm_eps)

    def _head_logits(self, last):
        """LM head on the last valid positions, fp32 out."""
        w = self.embed.t() if self.tied else self.lm_head
        return torch.matmul(last, w).float()

    def _embed_lookup(self, tokens):
        return F.embedding(tokens, self.embed).to(self.compute_dtype)

    @torch.no_grad()
    def forward_chunk(self, cache, tokens, start, tables, t_len):
        """tokens: [B, T] int; start: [B] first absolute position; tables:
        [B, NB]; t_len: [B] valid new tokens (<= T), all host arrays.
        Returns (logits [B, V] fp32, latents [L, B, T, H] or None), on the
        model's device."""
        tokens = np.asarray(tokens)
        idx = self._indices(tokens, start, tables, t_len, tokens.shape[1])
        x, latents = self._trunk(cache, idx)
        last = x.reshape(-1, x.shape[-1]).index_select(0, idx.last)
        return self._head_logits(self._final_norm(last)), latents

    # -------------------------------------------------------------- #
    # HCache restore
    # -------------------------------------------------------------- #
    def _restore_layer(self, cache, layer: int, latent, idx: BatchIndices):
        """Replay the K/V projection + RoPE + cache write for ONE layer from
        its saved latents [B, T, H]: no attention, no MLP."""
        k, v = self._kv(self.layers[layer], latent.to(self.compute_dtype),
                        idx.rope_pos)
        self._scatter_kv(cache.k[layer], cache.v[layer], k, v, idx)

    @torch.no_grad()
    def _restore_chunk(self, cache, layer0: int, lat_chunk,
                       idx: BatchIndices):
        """Replay layers ``layer0 .. layer0 + C`` from one latent slab
        ``[C, B, T, H]`` (one chunk = one dispatch of the JAX package)."""
        for i in range(lat_chunk.shape[0]):
            self._restore_layer(cache, layer0 + i, lat_chunk[i], idx)

    def restore_pipeline(self, cache, latents, start, tables, t_len,
                         progress_cb=None) -> "RestorePipeline":
        """Incremental chunk-at-a-time restore of one staged lane group."""
        return RestorePipeline(self, cache, latents, start, tables, t_len,
                               progress_cb=progress_cb)

    def restore_kv(self, cache, latents, start, tables, t_len,
                   progress_cb=None):
        """latents: host tensor [L, B, T, H]. Runs the restore pipeline to
        completion."""
        pipe = self.restore_pipeline(cache, latents, start, tables, t_len,
                                     progress_cb=progress_cb)
        while not pipe.done:
            pipe.advance()


class RestorePipeline:
    """One lane group's restore as a chunk pipeline with two lanes:

    * **ship lane**: the next layer-chunk's latent slab is copied from
      pinned host memory to the device with a ``non_blocking`` copy on a
      dedicated copy stream, at most ``_SHIP_DEPTH`` chunks ahead, each
      followed by an event;
    * **replay lane**: the compute stream waits on that event, then
      replays the chunk's layers.

    ``advance(max_chunks)`` issues up to ``max_chunks`` chunk replays and
    returns without waiting for the device, so the caller can issue a
    decode between advances and the ship hides under it. Interleaved
    forwards only touch other sequences' blocks. On the CPU a ship is a
    plain copy.
    """

    def __init__(self, model: PagedInferenceModel, cache, latents, start,
                 tables, t_len, progress_cb: Optional[Callable] = None):
        self.model = model
        self.cache = cache
        self.progress_cb = progress_cb
        self.latents = latents
        self._idx = model._indices(None, start, tables, t_len,
                                   latents.shape[2])
        L = model.n_layers
        C = model.restore_chunk_layers
        if C <= 0:
            per_layer = latents[0].numel() * latents.element_size()
            C = max(1, min(L, model.restore_chunk_bytes //
                           max(per_layer, 1)))
        self.chunk_layers = C
        self.bounds = list(range(0, L, C))
        self._next_replay = 0
        #: chunk index -> (device slab, ready event or None, host source)
        self._bufs = {}
        dev = model.device
        self._copy_stream = torch.cuda.Stream(dev) \
            if dev.type == "cuda" else None

    @property
    def chunks_total(self) -> int:
        return len(self.bounds)

    @property
    def chunks_issued(self) -> int:
        return self._next_replay

    @property
    def done(self) -> bool:
        return self._next_replay >= len(self.bounds)

    def _chunk(self, i):
        l0 = self.bounds[i]
        return self.latents[l0:l0 + self.chunk_layers]

    def _ship(self, i):
        # the lane slab is layer-major, so a chunk is one contiguous block
        src = self._chunk(i)
        if self._copy_stream is None:
            return src.clone(), None, None
        with torch.cuda.stream(self._copy_stream):
            buf = torch.empty(src.shape, dtype=src.dtype,
                              device=self.model.device)
            buf.copy_(src, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        # src (pinned) and buf stay referenced here until the replay that
        # waits on `ready` has been issued; buf is then handed to the
        # compute stream with record_stream
        return buf, ready, src

    def prefetch(self) -> int:
        """Ship ahead: issue the copies of the next unshipped chunks up to
        the in-flight depth. Returns the number of ships issued."""
        issued = 0
        i = self._next_replay
        while i < len(self.bounds) and len(self._bufs) < _SHIP_DEPTH:
            if i not in self._bufs:
                self._bufs[i] = self._ship(i)
                issued += 1
            i += 1
        return issued

    def advance(self, max_chunks: int = 0) -> int:
        """Issue up to ``max_chunks`` chunk replays (0 = all remaining),
        shipping the following chunks ahead of each. Returns the number of
        replays issued."""
        issued = 0
        while not self.done and (max_chunks <= 0 or issued < max_chunks):
            i = self._next_replay
            l0 = self.bounds[i]
            nbytes = self._chunk(i).numel() * self.latents.element_size()
            with annotate("hds.serve.restore.stage"):
                cur = self._bufs.pop(i, None) or self._ship(i)
                buf, ready, _src = cur
                if ready is not None:
                    stream = torch.cuda.current_stream(self.model.device)
                    stream.wait_event(ready)
                    buf.record_stream(stream)
                self._next_replay = i + 1
                self.model._restore_chunk(self.cache, l0, buf, self._idx)
                self.prefetch()
            if self.progress_cb is not None:
                self.progress_cb(l0, nbytes)
            issued += 1
        return issued

    def close(self) -> None:
        """Drop the shipped-ahead chunks once their copies have landed
        (an aborted lane must not free a buffer a copy still writes)."""
        for _buf, ready, _src in self._bufs.values():
            if ready is not None:
                ready.synchronize()
        self._bufs.clear()
