"""The GPT-J family (6B) for lockstep serving (counterpart of
``deepspeed_tpu/models/gptj.py``).

The parameter layouts and names are the JAX package's: ``wte [V, E]``; per
layer ``h_i.ln_1`` (``scale``, ``bias``), ``h_i.attn.{q,k,v}_proj.kernel
[E, H, D]`` and ``attn.out_proj.kernel [H, D, E]`` (no biases),
``h_i.fc_in`` and ``h_i.fc_out`` (biased); ``ln_f`` and the untied head
``lm_head`` with ``kernel [E, V]`` and ``bias [V]``.

As in the JAX model: RoPE in GPT-J's interleaved (rotate-every-two)
convention, adjacent dims ``(2i, 2i + 1)`` rotating together rather than
split halves, on the first ``rotary_dim`` dims of each head; one ``ln_1``
feeding both branches, ``x + attn(ln_1(x)) + mlp(ln_1(x))``; tanh GELU. The
6b preset has head dim 256 (4096 / 16), which K1 and K3 take.
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
from deepspeed_tpu_torch.models.gpt_neox import partial_rotary
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class GPTJConfig:
    vocab_size: int = 50400
    hidden_size: int = 4096
    intermediate_size: int = 16384
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    max_position_embeddings: int = 2048
    rotary_dim: int = 64
    rotary_emb_base: float = 10000.0
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


GPTJ_CONFIGS = {
    "test": dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=128, rotary_dim=8),
    "6b": dict(vocab_size=50400, hidden_size=4096, intermediate_size=16384,
               num_hidden_layers=28, num_attention_heads=16, rotary_dim=64),
}


def get_gptj_config(name: str, **overrides) -> GPTJConfig:
    return config_from(GPTJ_CONFIGS, GPTJConfig, name, **overrides)


def rotary_embedding_interleaved(x: torch.Tensor, positions: torch.Tensor,
                                 theta: float = 10000.0) -> torch.Tensor:
    """RoPE on ``x`` [B, L, H, D] at ``positions`` [B or 1, L] in GPT-J's
    interleaved layout: dims ``2i`` and ``2i + 1`` rotate by the angle of
    frequency i; in fp32, rounded back to x's dtype (JAX ``gptj.py:65``)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta**(torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions.to(x.device)[..., None].float() * inv_freq  # [B, L, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape).to(x.dtype)


class GPTJAttention(nn.Module):

    def __init__(self, cfg: GPTJConfig, device):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
        self.q_proj = Dense(cfg, (e, h, d), 1, device)
        self.k_proj = Dense(cfg, (e, h, d), 1, device)
        self.v_proj = Dense(cfg, (e, h, d), 1, device)
        self.out_proj = Dense(cfg, (h, d, e), 2, device)

    def forward(self, x, cache: Optional[Dict[str, torch.Tensor]] = None, prefix: str = ""):
        cfg = self.cfg
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        positions = cache_positions(cache, prefix, x.shape[1], x.device)
        q = partial_rotary(q, positions, cfg.rotary_dim, cfg.rotary_emb_base, rotary_embedding_interleaved)
        k = partial_rotary(k, positions, cfg.rotary_dim, cfg.rotary_emb_base, rotary_embedding_interleaved)
        causal, decode_lengths = True, None
        if cache is not None:
            k, v, decode_lengths = cache_write(cache, prefix, k, v)
            causal = False
        out = dot_product_attention(q, k, v, backend=cfg.attention_backend, causal=causal,
                                    decode_lengths=decode_lengths)
        return self.out_proj(out)


class GPTJBlock(nn.Module):

    def __init__(self, cfg: GPTJConfig, device):
        super().__init__()
        e = cfg.hidden_size
        self.ln_1 = LayerNorm(cfg, e, "layer_norm_eps", device)
        self.attn = GPTJAttention(cfg, device)
        self.fc_in = Dense(cfg, (e, cfg.intermediate_size), 1, device, bias=True)
        self.fc_out = Dense(cfg, (cfg.intermediate_size, e), 1, device, bias=True)

    def forward(self, x, cache=None, prefix=""):
        h = self.ln_1(x)  # one LayerNorm feeds both branches
        mlp = self.fc_out(F.gelu(self.fc_in(h), approximate="tanh"))
        return x + self.attn(h, cache, prefix) + mlp


class GPTJForCausalLM(nn.Module):
    """GPT-J with the untied, biased ``lm_head``. ``model(ids)`` -> logits
    ``[B, L, V]`` in the compute dtype; ``model(ids, cache)`` runs the decode
    branch and updates ``cache`` in place."""

    streamed_block_prefixes = ("h_",)

    def __init__(self, config: GPTJConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        self.wte = nn.Parameter(torch.empty((cfg.vocab_size, cfg.hidden_size), dtype=cfg.param_dtype,
                                            device=dev))
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"h_{i}", GPTJBlock(cfg, dev))
        self.ln_f = LayerNorm(cfg, cfg.hidden_size, "layer_norm_eps", dev)
        self.lm_head = Dense(cfg, (cfg.hidden_size, cfg.vocab_size), 1, dev, bias=True)
        if dev.type != "meta":  # a skeleton for kernel injection draws nothing
            self.reset_parameters(generator)

    @property
    def blocks(self):
        return [getattr(self, f"h_{i}") for i in range(self.config.num_hidden_layers)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX model's init (``models/common.init_decoder``)."""
        init_decoder(self, generator, ("wte",))

    def cache_shapes(self, batch_size: int):
        cfg = self.config
        return decode_cache_shapes([f"h_{i}/attn" for i in range(cfg.num_hidden_layers)], batch_size,
                                   cfg.max_position_embeddings, cfg.num_attention_heads, cfg.head_dim,
                                   cfg.dtype, self.device)

    def forward(self, input_ids: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None):
        cfg = self.config
        x = embed_lookup(self.wte.to(cfg.dtype), input_ids.to(self.device))
        for i, block in enumerate(self.blocks):
            x = maybe_remat(block, cfg, i, enabled=cfg.remat and cache is None)(x, cache, f"h_{i}/attn/")
        return self.lm_head(self.ln_f(x))
