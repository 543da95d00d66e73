"""The BLOOM family for lockstep serving (counterpart of
``deepspeed_tpu/models/bloom.py``).

The parameter layouts and names are the JAX package's: ``word_embeddings
[V, E]`` (the tied head) and ``word_embeddings_layernorm``; per layer
``h_i.input_layernorm``, ``h_i.self_attention.query_key_value`` (``kernel
[E, H, 3, D]``, ``bias [H, 3, D]``), ``self_attention.dense`` (``kernel [H,
D, E]``, ``bias``), ``h_i.post_attention_layernorm``, ``dense_h_to_4h`` and
``dense_4h_to_h`` (biased); ``ln_f``.

As in the JAX model: ALiBi as an additive logit bias ``slope[h] * k_pos``
over the keys of the call (the cache's length on a cached call; softmax is
shift-invariant per row, so absolute key positions equal the relative
form), the slopes of the nearest power-of-two head count with the
interleaved extras for any other count; tanh GELU. Attention goes through
the ``"xla"`` backend, the one that takes a bias: JAX's flash backend hands
a bias to XLA too, and kernel injection keeps BLOOM on ``"xla"`` by an
explicit rule (``inference/engine.py``), where the port's flash backend
would raise.
"""

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.common import (Dense, LayerNorm, cache_write, config_from,
                                               decode_cache_shapes, embed_lookup, init_decoder,
                                               maybe_remat, refuse_later_fields, tied_logits)
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 64
    n_head: int = 8
    n_layer: int = 2
    layer_norm_epsilon: float = 1e-5
    max_position_embeddings: int = 2048  # cache size only; ALiBi needs no table
    dtype: torch.dtype = torch.float32  # compute dtype; params stay in param_dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    fused_head_loss_chunk: int = 0
    attention_backend: str = "xla"

    def __post_init__(self):
        refuse_later_fields(self)

    @property
    def head_dim(self):
        return self.hidden_size // self.n_head


BLOOM_CONFIGS = {
    "test": dict(vocab_size=256, hidden_size=64, n_head=4, n_layer=2, max_position_embeddings=128),
    "560m": dict(hidden_size=1024, n_head=16, n_layer=24),
    "1b7": dict(hidden_size=2048, n_head=16, n_layer=24),
    "7b1": dict(hidden_size=4096, n_head=32, n_layer=30),
    "176b": dict(hidden_size=14336, n_head=112, n_layer=70),
}


def get_bloom_config(name: str, **overrides) -> BloomConfig:
    return config_from(BLOOM_CONFIGS, BloomConfig, name, **overrides)


def alibi_slopes(n_head: int) -> torch.Tensor:
    """Per-head ALiBi slopes, fp32 (the paper's construction: the powers of
    ``2^(-8/n)`` for the nearest power-of-two head count n, then every other
    slope of 2n for the remaining heads)."""

    def pow2_slopes(n):
        start = 2.0**(-(2.0**-(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(n_head).is_integer():
        slopes = pow2_slopes(n_head)
    else:
        closest = 2**math.floor(math.log2(n_head))
        slopes = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][:n_head - closest]
    return torch.tensor(slopes, dtype=torch.float32)


def alibi_bias(n_head: int, kv_len: int, device=None) -> torch.Tensor:
    """``[1, H, 1, Lk]`` additive logit bias ``slope[h] * k_pos``."""
    slopes = alibi_slopes(n_head).to(device)
    return (slopes[:, None] * torch.arange(kv_len, dtype=torch.float32, device=device)[None, :])[None, :, None, :]


class BloomAttention(nn.Module):

    def __init__(self, cfg: BloomConfig, device):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.hidden_size, cfg.n_head, cfg.head_dim
        self.query_key_value = Dense(cfg, (e, h, 3, d), 1, device, bias=True)
        self.dense = Dense(cfg, (h, d, e), 2, device, bias=True)

    def forward(self, x, cache: Optional[Dict[str, torch.Tensor]] = None, prefix: str = ""):
        cfg = self.cfg
        qkv = self.query_key_value(x)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        causal, decode_lengths = True, None
        if cache is not None:
            k, v, decode_lengths = cache_write(cache, prefix, k, v)
            causal = False
        out = dot_product_attention(q, k, v, backend=cfg.attention_backend, causal=causal,
                                    bias=alibi_bias(cfg.n_head, k.shape[1], x.device),
                                    decode_lengths=decode_lengths)
        return self.dense(out)


class BloomBlock(nn.Module):

    def __init__(self, cfg: BloomConfig, device):
        super().__init__()
        e = cfg.hidden_size
        self.input_layernorm = LayerNorm(cfg, e, "layer_norm_epsilon", device)
        self.self_attention = BloomAttention(cfg, device)
        self.post_attention_layernorm = LayerNorm(cfg, e, "layer_norm_epsilon", device)
        self.dense_h_to_4h = Dense(cfg, (e, 4 * e), 1, device, bias=True)
        self.dense_4h_to_h = Dense(cfg, (4 * e, e), 1, device, bias=True)

    def forward(self, x, cache=None, prefix=""):
        x = x + self.self_attention(self.input_layernorm(x), cache, prefix)
        h = F.gelu(self.dense_h_to_4h(self.post_attention_layernorm(x)), approximate="tanh")
        return x + self.dense_4h_to_h(h)


class BloomForCausalLM(nn.Module):
    """BLOOM with the tied LM head and the embedding LayerNorm.
    ``model(ids)`` -> logits ``[B, L, V]`` in the compute dtype;
    ``model(ids, cache)`` runs the decode branch and updates ``cache`` in
    place."""

    streamed_block_prefixes = ("h_",)
    #: kernel injection keeps this model on the ``"xla"`` backend: ALiBi is
    #: an additive logit bias, which JAX's flash backend hands to XLA
    #: (``ops/pallas/flash_attention.py:721-737``) and the port's refuses
    xla_attention_reason = "its ALiBi bias, which the flash kernels do not take"

    def __init__(self, config: BloomConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        self.word_embeddings = nn.Parameter(torch.empty((cfg.vocab_size, cfg.hidden_size),
                                                        dtype=cfg.param_dtype, device=dev))
        self.word_embeddings_layernorm = LayerNorm(cfg, cfg.hidden_size, "layer_norm_epsilon", dev)
        for i in range(cfg.n_layer):
            setattr(self, f"h_{i}", BloomBlock(cfg, dev))
        self.ln_f = LayerNorm(cfg, cfg.hidden_size, "layer_norm_epsilon", dev)
        if dev.type != "meta":  # a skeleton for kernel injection draws nothing
            self.reset_parameters(generator)

    @property
    def blocks(self):
        return [getattr(self, f"h_{i}") for i in range(self.config.n_layer)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX model's init (``models/common.init_decoder``)."""
        init_decoder(self, generator, ("word_embeddings",))

    def cache_shapes(self, batch_size: int):
        cfg = self.config
        return decode_cache_shapes([f"h_{i}/self_attention" for i in range(cfg.n_layer)], batch_size,
                                   cfg.max_position_embeddings, cfg.n_head, cfg.head_dim, cfg.dtype,
                                   self.device)

    def forward(self, input_ids: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None):
        cfg = self.config
        wte = self.word_embeddings.to(cfg.dtype)
        x = self.word_embeddings_layernorm(embed_lookup(wte, input_ids.to(self.device)))
        for i, block in enumerate(self.blocks):
            x = maybe_remat(block, cfg, i, enabled=cfg.remat and cache is None)(
                x, cache, f"h_{i}/self_attention/")
        return tied_logits(self.ln_f(x), wte, cfg.dtype)
