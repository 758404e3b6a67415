"""Weights from the JAX package's ``LlamaForCausalLM`` param tree.

The tree (nested dicts of arrays, as ``model.init(...)["params"]`` gives
it, converted to numpy) keeps its layout: kernels stay ``[in, out]`` and
go through ``torch.matmul`` as the JAX package's ``x @ w`` does, so both
packages compute the same thing on the same weights. The paths mapped are
the ones ``hcache_deepspeed_tpu/inference/model.py:162-176`` reads.
"""

import numpy as np
import torch

from ..models.llama import LlamaConfig

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def params_from_jax(tree, cfg: LlamaConfig, device="cpu", dtype=None):
    """Nested dict of arrays -> the same nested dict of torch tensors on
    ``device`` in ``dtype`` (default: the config's compute dtype)."""
    dtype = dtype or cfg.compute_dtype

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    out = {"embed_tokens": {"embedding": t(tree["embed_tokens"]["embedding"])},
           "norm": {"weight": t(tree["norm"]["weight"])}}
    for i in range(cfg.n_layer):
        lp = tree[f"layers_{i}"]
        out[f"layers_{i}"] = {
            "input_layernorm": {
                "weight": t(lp["input_layernorm"]["weight"])},
            "post_attention_layernorm": {
                "weight": t(lp["post_attention_layernorm"]["weight"])},
            "self_attn": {n: {"kernel": t(lp["self_attn"][n]["kernel"])}
                          for n in _ATTN},
            "mlp": {n: {"kernel": t(lp["mlp"][n]["kernel"])} for n in _MLP},
        }
    if not cfg.tie_word_embeddings:
        out["lm_head"] = {"kernel": t(tree["lm_head"]["kernel"])}
    return out
