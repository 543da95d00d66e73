"""The OPT family for lockstep serving (counterpart of
``deepspeed_tpu/models/opt.py``).

The parameter layouts and names are the JAX package's: ``embed_tokens [V,
embed_dim]`` (the tied head), ``embed_positions [P + 2, E]``; per layer
``layers_i.self_attn.{q,k,v}_proj`` (``kernel [E, H, D]``, ``bias [H,
D]``), ``self_attn.out_proj`` (``kernel [H, D, E]``, ``bias``),
``self_attn_layer_norm``, ``fc1``, ``fc2`` and ``final_layer_norm``; the
model's ``final_layer_norm`` under ``do_layer_norm_before``, and
``project_in [embed_dim, E]`` / ``project_out [E, embed_dim]`` (no bias)
where ``word_embed_proj_dim`` differs from ``hidden_size`` (the 350m
preset).

As in the JAX model: learned positions read at ``position + 2``
(``POSITION_OFFSET``, HF's ``OPTLearnedPositionalEmbedding``), from the
cache's host ``position_index`` on a cached call; ReLU MLP; pre-LN blocks
under ``do_layer_norm_before``, post-LN (the 350m preset) otherwise.
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
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    word_embed_proj_dim: Optional[int] = None  # != hidden_size: project_in/out
    do_layer_norm_before: bool = True
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32  # compute dtype; params stay in param_dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    attention_backend: str = "xla"
    fused_head_loss_chunk: int = 0

    def __post_init__(self):
        refuse_later_fields(self)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def embed_dim(self):
        return self.word_embed_proj_dim or self.hidden_size

    @property
    def has_embed_proj(self) -> bool:
        """project_in/out exist only where the embedding width differs from
        the hidden width (HF sets ``word_embed_proj_dim == hidden_size`` for
        every checkpoint but 350m: no projection layers)."""
        return self.word_embed_proj_dim not in (None, self.hidden_size)


OPT_CONFIGS = {
    "test": dict(vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=128),
    "125m": dict(hidden_size=768, ffn_dim=3072, num_hidden_layers=12, num_attention_heads=12),
    "350m": dict(hidden_size=1024, ffn_dim=4096, num_hidden_layers=24, num_attention_heads=16,
                 word_embed_proj_dim=512, do_layer_norm_before=False),
    "1.3b": dict(hidden_size=2048, ffn_dim=8192, num_hidden_layers=24, num_attention_heads=32),
    "6.7b": dict(hidden_size=4096, ffn_dim=16384, num_hidden_layers=32, num_attention_heads=32),
}

POSITION_OFFSET = 2  # HF OPTLearnedPositionalEmbedding.offset


def get_opt_config(name: str, **overrides) -> OPTConfig:
    return config_from(OPT_CONFIGS, OPTConfig, name, **overrides)


class OPTAttention(nn.Module):

    def __init__(self, cfg: OPTConfig, device):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
        self.q_proj = Dense(cfg, (e, h, d), 1, device, bias=True)
        self.k_proj = Dense(cfg, (e, h, d), 1, device, bias=True)
        self.v_proj = Dense(cfg, (e, h, d), 1, device, bias=True)
        self.out_proj = Dense(cfg, (h, d, e), 2, device, bias=True)

    def forward(self, x, cache: Optional[Dict[str, torch.Tensor]] = None, prefix: str = ""):
        cfg = self.cfg
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        causal, decode_lengths = True, None
        if cache is not None:
            k, v, decode_lengths = cache_write(cache, prefix, k, v)
            causal = False
        out = dot_product_attention(q, k, v, backend=cfg.attention_backend, causal=causal,
                                    decode_lengths=decode_lengths)
        return self.out_proj(out)


class OPTDecoderLayer(nn.Module):

    def __init__(self, cfg: OPTConfig, device):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.self_attn = OPTAttention(cfg, device)
        self.self_attn_layer_norm = LayerNorm(cfg, e, "layer_norm_eps", device)
        self.fc1 = Dense(cfg, (e, cfg.ffn_dim), 1, device, bias=True)
        self.fc2 = Dense(cfg, (cfg.ffn_dim, e), 1, device, bias=True)
        self.final_layer_norm = LayerNorm(cfg, e, "layer_norm_eps", device)

    def forward(self, x, cache=None, prefix=""):
        pre = self.cfg.do_layer_norm_before
        h = self.self_attn(self.self_attn_layer_norm(x) if pre else x, cache, prefix)
        x = x + h
        if not pre:
            x = self.self_attn_layer_norm(x)
        h = self.fc2(F.relu(self.fc1(self.final_layer_norm(x) if pre else x)))
        x = x + h
        return x if pre else self.final_layer_norm(x)


class OPTForCausalLM(nn.Module):
    """OPT with the tied LM head. ``model(ids)`` -> logits ``[B, L, V]`` in
    the compute dtype; ``model(ids, cache)`` runs the decode branch and
    updates ``cache`` in place."""

    streamed_block_prefixes = ("layers_",)

    def __init__(self, config: OPTConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        e = cfg.hidden_size
        self.embed_tokens = nn.Parameter(torch.empty((cfg.vocab_size, cfg.embed_dim),
                                                     dtype=cfg.param_dtype, device=dev))
        self.embed_positions = nn.Parameter(torch.empty((cfg.max_position_embeddings + POSITION_OFFSET, e),
                                                        dtype=cfg.param_dtype, device=dev))
        if cfg.has_embed_proj:
            self.project_in = Dense(cfg, (cfg.embed_dim, e), 1, dev)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layers_{i}", OPTDecoderLayer(cfg, dev))
        if cfg.do_layer_norm_before:
            self.final_layer_norm = LayerNorm(cfg, e, "layer_norm_eps", dev)
        if cfg.has_embed_proj:
            self.project_out = Dense(cfg, (e, cfg.embed_dim), 1, dev)
        if dev.type != "meta":  # a skeleton for kernel injection draws nothing
            self.reset_parameters(generator)

    @property
    def blocks(self):
        return [getattr(self, f"layers_{i}") for i in range(self.config.num_hidden_layers)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX model's init (``models/common.init_decoder``;
        ``embed_positions`` normal 0.01)."""
        init_decoder(self, generator, ("embed_tokens",), ("embed_positions",))

    def cache_shapes(self, batch_size: int):
        cfg = self.config
        return decode_cache_shapes([f"layers_{i}/self_attn" for i in range(cfg.num_hidden_layers)],
                                   batch_size, cfg.max_position_embeddings, cfg.num_attention_heads,
                                   cfg.head_dim, cfg.dtype, self.device, position_index=True)

    def forward(self, input_ids: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None):
        cfg = self.config
        ids = input_ids.to(self.device)
        wte = self.embed_tokens.to(cfg.dtype)
        x = embed_lookup(wte, ids)
        if cfg.has_embed_proj:
            x = self.project_in(x)
        x = x + learned_positions(self.embed_positions, cache, ids.shape[1], POSITION_OFFSET).to(cfg.dtype)
        for i, block in enumerate(self.blocks):
            x = maybe_remat(block, cfg, i, enabled=cfg.remat and cache is None)(
                x, cache, f"layers_{i}/self_attn/")
        if cfg.do_layer_norm_before:
            x = self.final_layer_norm(x)
        if cfg.has_embed_proj:
            x = self.project_out(x)
        return tied_logits(x, wte, cfg.dtype)
