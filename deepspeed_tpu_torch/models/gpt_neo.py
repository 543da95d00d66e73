"""The GPT-Neo family (125M, 1.3B, 2.7B) for lockstep serving (counterpart
of ``deepspeed_tpu/models/gpt_neo.py``).

The parameter layouts and names are the JAX package's: ``wte [V, E]`` (the
tied head), ``wpe [P, E]``; per layer ``h_i.ln_1``, ``h_i.attn.{q,k,v}_proj
.kernel [E, H, D]`` (no bias), ``attn.out_proj`` (``kernel [H, D, E]``,
``bias``), ``h_i.ln_2``, ``h_i.c_fc`` and ``h_i.c_proj``; ``ln_f``.

As in the JAX model: unscaled attention logits (``scale=1.0``), every odd
layer local (a sliding ``window_size`` on the forward, K1's ``window``),
tanh GELU, learned positions read at the cache's host ``position_index`` on a
cached call. Cached decode attends the whole cache in every layer, local
ones too (JAX ``gpt_neo.py:103``, the Mistral preset's convention), where
HF's GPT-Neo keeps the window: the JAX package is the reference.
"""

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.common import (Dense, LayerNorm, cache_write, config_from,
                                               decode_cache_shapes, embed_lookup, init_decoder,
                                               learned_positions, maybe_remat, refuse_later_fields,
                                               tied_logits)
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class GPTNeoConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    # every odd layer is "local": attends (pos - window_size, pos]
    window_size: int = 256
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32  # compute dtype; params stay in param_dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    remat_every: int = 1
    remat_policy: Optional[str] = None
    fused_head_loss_chunk: int = 0
    attention_backend: str = "xla"

    def __post_init__(self):
        refuse_later_fields(self)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    def attention_type(self, layer_idx: int) -> str:
        # HF attention_types [[["global", "local"], n/2]]: even global, odd local
        return "local" if layer_idx % 2 else "global"


GPT_NEO_CONFIGS = {
    "test": dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=128, window_size=8),
    "125m": dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                 num_attention_heads=12),
    "1.3b": dict(hidden_size=2048, intermediate_size=8192, num_hidden_layers=24,
                 num_attention_heads=16),
    "2.7b": dict(hidden_size=2560, intermediate_size=10240, num_hidden_layers=32,
                 num_attention_heads=20),
}


def get_gpt_neo_config(name: str, **overrides) -> GPTNeoConfig:
    return config_from(GPT_NEO_CONFIGS, GPTNeoConfig, name, **overrides)


class GPTNeoAttention(nn.Module):

    def __init__(self, cfg: GPTNeoConfig, layer_idx: int, device):
        super().__init__()
        self.cfg = cfg
        self.local = cfg.attention_type(layer_idx) == "local"
        e, h, d = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
        self.q_proj = Dense(cfg, (e, h, d), 1, device)
        self.k_proj = Dense(cfg, (e, h, d), 1, device)
        self.v_proj = Dense(cfg, (e, h, d), 1, device)
        self.out_proj = Dense(cfg, (h, d, e), 2, device, bias=True)

    def forward(self, x, cache: Optional[Dict[str, torch.Tensor]] = None, prefix: str = ""):
        cfg = self.cfg
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        causal, decode_lengths = True, None
        window = cfg.window_size if self.local else None
        if cache is not None:
            k, v, decode_lengths = cache_write(cache, prefix, k, v)
            causal, window = False, None  # decode attends the whole cache
        out = dot_product_attention(q, k, v, backend=cfg.attention_backend, causal=causal, scale=1.0,
                                    decode_lengths=decode_lengths, window=window)
        return self.out_proj(out)


class GPTNeoBlock(nn.Module):

    def __init__(self, cfg: GPTNeoConfig, layer_idx: int, device):
        super().__init__()
        e = cfg.hidden_size
        self.ln_1 = LayerNorm(cfg, e, "layer_norm_eps", device)
        self.attn = GPTNeoAttention(cfg, layer_idx, device)
        self.ln_2 = LayerNorm(cfg, e, "layer_norm_eps", device)
        self.c_fc = Dense(cfg, (e, cfg.intermediate_size), 1, device, bias=True)
        self.c_proj = Dense(cfg, (cfg.intermediate_size, e), 1, device, bias=True)

    def forward(self, x, cache=None, prefix=""):
        x = x + self.attn(self.ln_1(x), cache, prefix)
        return x + self.c_proj(F.gelu(self.c_fc(self.ln_2(x)), approximate="tanh"))


class GPTNeoForCausalLM(nn.Module):
    """GPT-Neo with the tied LM head. ``model(ids)`` -> logits ``[B, L, V]``
    in the compute dtype; ``model(ids, cache)`` runs the decode branch and
    updates ``cache`` in place."""

    streamed_block_prefixes = ("h_",)

    def __init__(self, config: GPTNeoConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        self.wte = nn.Parameter(torch.empty((cfg.vocab_size, cfg.hidden_size), dtype=cfg.param_dtype,
                                            device=dev))
        self.wpe = nn.Parameter(torch.empty((cfg.max_position_embeddings, cfg.hidden_size),
                                            dtype=cfg.param_dtype, device=dev))
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"h_{i}", GPTNeoBlock(cfg, i, dev))
        self.ln_f = LayerNorm(cfg, cfg.hidden_size, "layer_norm_eps", dev)
        if dev.type != "meta":  # a skeleton for kernel injection draws nothing
            self.reset_parameters(generator)

    @property
    def blocks(self):
        return [getattr(self, f"h_{i}") for i in range(self.config.num_hidden_layers)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX model's init (``models/common.init_decoder``; ``wpe``
        normal 0.01)."""
        init_decoder(self, generator, ("wte",), ("wpe",))

    def cache_shapes(self, batch_size: int):
        cfg = self.config
        return decode_cache_shapes([f"h_{i}/attn" for i in range(cfg.num_hidden_layers)], batch_size,
                                   cfg.max_position_embeddings, cfg.num_attention_heads, cfg.head_dim,
                                   cfg.dtype, self.device, position_index=True)

    def forward(self, input_ids: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None):
        cfg = self.config
        ids = input_ids.to(self.device)
        wte = self.wte.to(cfg.dtype)
        x = embed_lookup(wte, ids) + learned_positions(self.wpe, cache, ids.shape[1]).to(cfg.dtype)
        for i, block in enumerate(self.blocks):
            x = maybe_remat(block, cfg, i, enabled=cfg.remat and cache is None)(x, cache, f"h_{i}/attn/")
        return tied_logits(self.ln_f(x), wte, cfg.dtype)
