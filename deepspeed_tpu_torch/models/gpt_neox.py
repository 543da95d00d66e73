"""The GPT-NeoX family (Pythia, 20B) for lockstep serving (counterpart of
``deepspeed_tpu/models/gpt_neox.py``).

The parameter layouts and names are the JAX package's, so
``checkpoint/from_jax.py`` is a renaming: ``embed_in [V, E]``; per layer
``layers_i.attention.query_key_value.kernel [E, H, 3, D]`` with its ``bias
[H, 3, D]`` (NeoX's per-head interleaved fused qkv), ``attention.dense.kernel
[H, D, E]`` and ``bias [E]``, ``dense_h_to_4h`` / ``dense_4h_to_h`` (biased),
``input_layernorm`` and ``post_attention_layernorm`` (``scale``, ``bias``);
``final_layer_norm`` and the untied head ``embed_out.kernel [E, V]``.

As in the JAX model: RoPE in its half-split layout on the first
``rotary_ndims`` dims of each head only (the rest pass through), exact-erf
GELU, and the parallel residual ``x + attn(ln1(x)) + mlp(ln2(x))`` unless
``use_parallel_residual`` is off. The 20b preset has head dim 96
(6144 / 64), which K1 and K3 take. The decode cache is ``[B,
max_position_embeddings, H, D]`` per layer with a host write index
(``models/common.cache_write``). The fused LM-head loss is the families'
training slice (ROADMAP.md Queue A item 6).
"""

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.common import (Dense, LayerNorm, cache_positions, cache_write,
                                               config_from, decode_cache_shapes, embed_lookup,
                                               init_decoder, maybe_remat, refuse_later_fields)
from deepspeed_tpu_torch.models.llama import rotary_embedding
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50432
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    rotary_pct: float = 0.25
    rotary_emb_base: float = 10000.0
    use_parallel_residual: bool = True
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32  # compute dtype; params stay in param_dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    fused_head_loss_chunk: int = 0
    attention_backend: str = "xla"

    def __post_init__(self):
        refuse_later_fields(self)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_ndims(self):
        return int(self.head_dim * self.rotary_pct)


GPT_NEOX_CONFIGS = {
    "test": dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=128),
    "pythia-160m": dict(vocab_size=50304, hidden_size=768, intermediate_size=3072,
                        num_hidden_layers=12, num_attention_heads=12),
    "pythia-1.4b": dict(vocab_size=50304, hidden_size=2048, intermediate_size=8192,
                        num_hidden_layers=24, num_attention_heads=16),
    "pythia-6.9b": dict(hidden_size=4096, intermediate_size=16384, num_hidden_layers=32,
                        num_attention_heads=32),
    "20b": dict(vocab_size=50432, hidden_size=6144, intermediate_size=24576,
                num_hidden_layers=44, num_attention_heads=64),
}


def get_gpt_neox_config(name: str, **overrides) -> GPTNeoXConfig:
    return config_from(GPT_NEOX_CONFIGS, GPTNeoXConfig, name, **overrides)


def partial_rotary(x: torch.Tensor, positions: torch.Tensor, ndims: int, base: float,
                   rotary=rotary_embedding) -> torch.Tensor:
    """``rotary`` on the first ``ndims`` of the head dim; the rest passes
    through (NeoX's and GPT-J's convention)."""
    return torch.cat([rotary(x[..., :ndims], positions, base), x[..., ndims:]], dim=-1)


class GPTNeoXAttention(nn.Module):

    def __init__(self, cfg: GPTNeoXConfig, device):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
        self.query_key_value = Dense(cfg, (e, h, 3, d), 1, device, bias=True)
        self.dense = Dense(cfg, (h, d, e), 2, device, bias=True)

    def forward(self, x, cache: Optional[Dict[str, torch.Tensor]] = None, prefix: str = ""):
        cfg = self.cfg
        qkv = self.query_key_value(x)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]  # [B, L, H, D]
        positions = cache_positions(cache, prefix, x.shape[1], x.device)
        q = partial_rotary(q, positions, cfg.rotary_ndims, cfg.rotary_emb_base)
        k = partial_rotary(k, positions, cfg.rotary_ndims, cfg.rotary_emb_base)
        causal, decode_lengths = True, None
        if cache is not None:
            k, v, decode_lengths = cache_write(cache, prefix, k, v)
            causal = False
        out = dot_product_attention(q, k, v, backend=cfg.attention_backend, causal=causal,
                                    decode_lengths=decode_lengths)
        return self.dense(out)


class GPTNeoXLayer(nn.Module):

    def __init__(self, cfg: GPTNeoXConfig, device):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.input_layernorm = LayerNorm(cfg, e, "layer_norm_eps", device)
        self.attention = GPTNeoXAttention(cfg, device)
        self.post_attention_layernorm = LayerNorm(cfg, e, "layer_norm_eps", device)
        self.dense_h_to_4h = Dense(cfg, (e, cfg.intermediate_size), 1, device, bias=True)
        self.dense_4h_to_h = Dense(cfg, (cfg.intermediate_size, e), 1, device, bias=True)

    def mlp(self, h):
        return self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(h)))  # exact (erf) GELU

    def forward(self, x, cache=None, prefix=""):
        attn = self.attention(self.input_layernorm(x), cache, prefix)
        if self.cfg.use_parallel_residual:
            return x + attn + self.mlp(self.post_attention_layernorm(x))
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x))


class GPTNeoXForCausalLM(nn.Module):
    """GPT-NeoX with the untied ``embed_out`` head. ``model(ids)`` -> logits
    ``[B, L, V]`` in the compute dtype; ``model(ids, cache)`` runs the decode
    branch and updates ``cache`` in place."""

    streamed_block_prefixes = ("layers_",)

    def __init__(self, config: GPTNeoXConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        self.embed_in = nn.Parameter(torch.empty((cfg.vocab_size, cfg.hidden_size),
                                                 dtype=cfg.param_dtype, device=dev))
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layers_{i}", GPTNeoXLayer(cfg, dev))
        self.final_layer_norm = LayerNorm(cfg, cfg.hidden_size, "layer_norm_eps", dev)
        self.embed_out = Dense(cfg, (cfg.hidden_size, cfg.vocab_size), 1, dev)
        if dev.type != "meta":  # a skeleton for kernel injection draws nothing
            self.reset_parameters(generator)

    @property
    def blocks(self):
        return [getattr(self, f"layers_{i}") for i in range(self.config.num_hidden_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX model's init: normal 0.02 for ``embed_in`` and every
        kernel, zero biases, unit norm scales; from ``generator`` (a fresh
        one seeded 0 when None)."""
        init_decoder(self, generator, ("embed_in",))

    def cache_shapes(self, batch_size: int):
        cfg = self.config
        return decode_cache_shapes([f"layers_{i}/attention" for i in range(cfg.num_hidden_layers)],
                                   batch_size, cfg.max_position_embeddings,
                                   cfg.num_attention_heads, cfg.head_dim, cfg.dtype, self.device)

    def forward(self, input_ids: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None):
        cfg = self.config
        x = embed_lookup(self.embed_in.to(cfg.dtype), input_ids.to(self.device))
        for i, block in enumerate(self.blocks):
            x = maybe_remat(block, cfg, i, enabled=cfg.remat and cache is None)(
                x, cache, f"layers_{i}/attention/")
        return self.embed_out(self.final_layer_norm(x))
