"""The Falcon family for lockstep serving (counterpart of
``deepspeed_tpu/models/falcon.py``).

The parameter layouts and names are the JAX package's: ``word_embeddings
[V, E]`` (the tied head); per layer ``h_i.self_attention.query_key_value
.kernel [E, KV, G + 2, D]`` (group-interleaved: for each kv head its G
query heads, then its key, then its value; no bias), ``self_attention.dense
.kernel [H, D, E]``, ``dense_h_to_4h`` / ``dense_4h_to_h`` (no biases) and
either ``input_layernorm`` (7B) or ``ln_attn`` and ``ln_mlp``
(``new_decoder_architecture``, 40B); ``ln_f``.

As in the JAX model: RoPE on the whole head dim (half-split), exact GELU,
the parallel residual ``x + attn(ln(x)) + mlp(ln'(x))``; multi-query or
grouped attention repeats K and V to every query head after the cache, so
the cache holds ``num_kv_heads`` heads (JAX ``falcon.py:116-118``).
Falcon-7b has 71 heads of 64 over one kv head.
"""

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.common import (Dense, LayerNorm, cache_positions, cache_write,
                                               config_from, decode_cache_shapes, embed_lookup,
                                               init_decoder, maybe_remat, refuse_later_fields,
                                               tied_logits)
from deepspeed_tpu_torch.models.llama import rotary_embedding
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class FalconConfig:
    vocab_size: int = 65024
    hidden_size: int = 4544
    num_attention_heads: int = 71
    num_kv_heads: int = 1  # 1 = multi-query (7B); > 1 = grouped (40B/180B)
    num_hidden_layers: int = 32
    max_position_embeddings: int = 2048
    layer_norm_epsilon: float = 1e-5
    rope_theta: float = 10000.0
    new_decoder_architecture: bool = False  # True: separate ln_attn / ln_mlp
    dtype: torch.dtype = torch.float32  # compute dtype; params stay in param_dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    fused_head_loss_chunk: int = 0
    attention_backend: str = "xla"

    def __post_init__(self):
        refuse_later_fields(self)
        if self.num_attention_heads % self.num_kv_heads:
            raise ValueError(f"num_attention_heads {self.num_attention_heads} is not a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def q_per_kv(self):
        return self.num_attention_heads // self.num_kv_heads


FALCON_CONFIGS = {
    "test": dict(vocab_size=256, hidden_size=64, num_attention_heads=4, num_kv_heads=1,
                 num_hidden_layers=2, max_position_embeddings=128),
    "test-gqa": dict(vocab_size=256, hidden_size=64, num_attention_heads=4, num_kv_heads=2,
                     num_hidden_layers=2, max_position_embeddings=128,
                     new_decoder_architecture=True),
    "7b": dict(hidden_size=4544, num_attention_heads=71, num_kv_heads=1, num_hidden_layers=32),
    "40b": dict(hidden_size=8192, num_attention_heads=128, num_kv_heads=8, num_hidden_layers=60,
                new_decoder_architecture=True),
}


def get_falcon_config(name: str, **overrides) -> FalconConfig:
    return config_from(FALCON_CONFIGS, FalconConfig, name, **overrides)


class FalconAttention(nn.Module):

    def __init__(self, cfg: FalconConfig, device):
        super().__init__()
        self.cfg = cfg
        e, d = cfg.hidden_size, cfg.head_dim
        self.query_key_value = Dense(cfg, (e, cfg.num_kv_heads, cfg.q_per_kv + 2, d), 1, device)
        self.dense = Dense(cfg, (cfg.num_attention_heads, d, e), 2, device)

    def forward(self, x, cache: Optional[Dict[str, torch.Tensor]] = None, prefix: str = ""):
        cfg = self.cfg
        b, l = x.shape[0], x.shape[1]
        kv, g, d = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
        qkv = self.query_key_value(x)                 # [B, L, KV, G + 2, D]
        q = qkv[..., :g, :].reshape(b, l, kv * g, d)  # [B, L, H, D]
        k, v = qkv[..., g, :], qkv[..., g + 1, :]     # [B, L, KV, D]
        positions = cache_positions(cache, prefix, l, x.device)
        q = rotary_embedding(q, positions, cfg.rope_theta)
        k = rotary_embedding(k, positions, cfg.rope_theta)
        causal, decode_lengths = True, None
        if cache is not None:
            k, v, decode_lengths = cache_write(cache, prefix, k, v)
            causal = False
        if g > 1:  # every query head reads its group's kv head
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        out = dot_product_attention(q, k, v, backend=cfg.attention_backend, causal=causal,
                                    decode_lengths=decode_lengths)
        return self.dense(out)


class FalconDecoderLayer(nn.Module):

    def __init__(self, cfg: FalconConfig, device):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        if cfg.new_decoder_architecture:
            self.ln_attn = LayerNorm(cfg, e, "layer_norm_epsilon", device)
            self.ln_mlp = LayerNorm(cfg, e, "layer_norm_epsilon", device)
        else:
            self.input_layernorm = LayerNorm(cfg, e, "layer_norm_epsilon", device)
        self.self_attention = FalconAttention(cfg, device)
        self.dense_h_to_4h = Dense(cfg, (e, 4 * e), 1, device)
        self.dense_4h_to_h = Dense(cfg, (4 * e, e), 1, device)

    def forward(self, x, cache=None, prefix=""):
        if self.cfg.new_decoder_architecture:
            attn_in, mlp_in = self.ln_attn(x), self.ln_mlp(x)
        else:
            attn_in = mlp_in = self.input_layernorm(x)
        attn = self.self_attention(attn_in, cache, prefix)
        return x + attn + self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(mlp_in)))  # parallel residual


class FalconForCausalLM(nn.Module):
    """Falcon with the tied LM head. ``model(ids)`` -> logits ``[B, L, V]`` in
    the compute dtype; ``model(ids, cache)`` runs the decode branch and
    updates ``cache`` in place."""

    streamed_block_prefixes = ("h_",)

    def __init__(self, config: FalconConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        self.word_embeddings = nn.Parameter(torch.empty((cfg.vocab_size, cfg.hidden_size),
                                                        dtype=cfg.param_dtype, device=dev))
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"h_{i}", FalconDecoderLayer(cfg, dev))
        self.ln_f = LayerNorm(cfg, cfg.hidden_size, "layer_norm_epsilon", dev)
        if dev.type != "meta":  # a skeleton for kernel injection draws nothing
            self.reset_parameters(generator)

    @property
    def blocks(self):
        return [getattr(self, f"h_{i}") for i in range(self.config.num_hidden_layers)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX model's init (``models/common.init_decoder``)."""
        init_decoder(self, generator, ("word_embeddings",))

    def cache_shapes(self, batch_size: int):
        cfg = self.config
        return decode_cache_shapes([f"h_{i}/self_attention" for i in range(cfg.num_hidden_layers)],
                                   batch_size, cfg.max_position_embeddings, cfg.num_kv_heads,
                                   cfg.head_dim, cfg.dtype, self.device)

    def forward(self, input_ids: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None):
        cfg = self.config
        wte = self.word_embeddings.to(cfg.dtype)
        x = embed_lookup(wte, input_ids.to(self.device))
        for i, block in enumerate(self.blocks):
            x = maybe_remat(block, cfg, i, enabled=cfg.remat and cache is None)(
                x, cache, f"h_{i}/self_attention/")
        return tied_logits(self.ln_f(x), wte, cfg.dtype)
