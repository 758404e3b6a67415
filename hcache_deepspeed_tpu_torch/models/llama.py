"""Llama family configuration (Llama-2 / Llama-3 style).

Counterpart of ``hcache_deepspeed_tpu/models/llama.py:38-105``: the same
config fields the serving path reads, with ``compute_dtype`` as a torch
dtype. The training modules come with the training slice.
"""

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32          # < n_head => GQA; == 1 => MQA
    max_positions: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"

    @property
    def head_dim(self):
        return self.hidden_size // self.n_head

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def llama2_7b(**kw):
    defaults = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=11008, n_layer=32, n_head=32,
                    n_kv_head=32, max_positions=4096, dtype="bfloat16")
    defaults.update(kw)
    return LlamaConfig(**defaults)


def llama3_8b(**kw):
    defaults = dict(vocab_size=128256, hidden_size=4096,
                    intermediate_size=14336, n_layer=32, n_head=32,
                    n_kv_head=8, max_positions=8192, rope_theta=500000.0,
                    dtype="bfloat16")
    defaults.update(kw)
    return LlamaConfig(**defaults)


def llama_tiny(**kw):
    """Test-scale config."""
    defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    n_layer=2, n_head=4, n_kv_head=2, max_positions=128)
    defaults.update(kw)
    return LlamaConfig(**defaults)


def random_params(cfg: LlamaConfig, seed: int = 0, device="cpu",
                  dtype=None):
    """Random weights in the JAX ``LlamaForCausalLM`` param layout
    (kernels ``[in, out]``), drawn on ``device`` from a seeded
    ``torch.Generator``: projections ~ N(0, 1/fan_in), embeddings
    ~ N(0, 1), norms 1."""
    dev = torch.device(device)
    dtype = dtype or cfg.compute_dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    D = cfg.head_dim

    def normal(*shape, std=1.0):
        w = torch.randn(*shape, generator=g, device=dev, dtype=dtype)
        return w.mul_(std)

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out, std=1.0 / math.sqrt(n_in))}

    def ones():
        return {"weight": torch.ones(H, device=dev, dtype=dtype)}

    params = {"embed_tokens": {"embedding": normal(V, H)}, "norm": ones()}
    for i in range(cfg.n_layer):
        params[f"layers_{i}"] = {
            "input_layernorm": ones(),
            "post_attention_layernorm": ones(),
            "self_attn": {"q_proj": dense(H, cfg.n_head * D),
                          "k_proj": dense(H, cfg.n_kv_head * D),
                          "v_proj": dense(H, cfg.n_kv_head * D),
                          "o_proj": dense(cfg.n_head * D, H)},
            "mlp": {"gate_proj": dense(H, I), "up_proj": dense(H, I),
                    "down_proj": dense(I, H)},
        }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(H, V)
    return params
