"""The LLaMA family (RMSNorm + RoPE + SwiGLU + GQA decoder) for training and
lockstep serving (counterpart of ``deepspeed_tpu/models/llama.py``).

The parameter layouts and names are the JAX package's, so weights carry
across one leaf to one tensor (``checkpoint/from_jax.py``): ``embed_tokens
[V, E]``; per layer ``layers_i.self_attn.{q,k,v}_proj.kernel [E, H(kv), D]``
(with ``bias [H(kv), D]`` under ``attention_bias``, Qwen2), ``o_proj.kernel
[H, D, E]``, ``mlp.{gate,up}_proj.kernel [E, I]``, ``down_proj.kernel [I,
E]``, ``input_layernorm.weight`` and ``post_attention_layernorm.weight``;
``norm.weight`` and the untied head ``lm_head.kernel [E, V]``.

As in the JAX model: RoPE in its half-split layout, in fp32; GQA repeats the
key/value heads after the cache (every decode step repeats the whole cache,
JAX ``llama.py:208-210``); the sliding window applies to the forward only,
never to cached decode; the decode cache is ``[B, max_position_embeddings,
Hkv, D]`` per layer with a scalar write index (``models/common.init_cache``),
updated in place. Every floating parameter is rounded to the compute dtype
where it is used, so fp32 master weights train with bf16 compute. With
``labels`` and ``fused_head_loss_chunk > 0`` the forward returns the chunked
fused LM-head loss on the ``[E, V]`` head instead of logits.

Mixtral (``moe_num_experts > 0``): every ``moe_layer_freq``-th layer swaps
its SwiGLU MLP for ``moe.MoE`` over ``moe_num_experts`` stacked SwiGLU
experts (``LlamaMLP.stacked``: ``layers_i.moe.deepspeed_moe.experts.
deepspeed_experts.{gate,up}_proj.kernel [E, H, I]``, ``down_proj.kernel
[E, I, H]``, the gate ``layers_i.moe.deepspeed_moe.gate.wg [H, E]``), top
``moe_k``, as JAX ``llama.py:246-270`` does. The model then sums the
layers' load-balancing losses and returns ``(logits, aux_total *
moe_aux_loss_coef)``, or adds that term to the fused head's loss in
training. Training-mode gating draws its noise (top-2's Gumbel second
choice) from a generator per layer, seeded from the caller's generator, so
a checkpointed layer routes the same way when it is recomputed.

``remat_policy`` names what a checkpointed layer keeps
(``runtime/activation_checkpointing``), ``attention_policy`` the flash
backward's. The TPU ``attention_blocks``
belongs to a later slice and raises ``NotImplementedError``; the per-slot
serving cache of
``ContinuousBatchingScheduler`` does not take this family, as the JAX
scheduler does not. The JAX model's ``attention_mask`` and
explicit ``positions`` arguments are not taken: neither JAX engine passes
them on the paths ported here.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.common import (Dense, StackedDense, cache_positions,  # noqa: F401
                                               cache_write, config_from, decode_cache_shapes,
                                               dense_init, embed_lookup,
                                               fused_head_loss_output, maybe_remat, rms_norm)
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import get_remat_policy

#: config fields of the JAX model that belong to later slices of the port,
#: with the value that means "off" and where the slice stands
_LATER_SLICES = {"attention_blocks": (None, "the attention-tuning slice")}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32  # < num_attention_heads: GQA
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.float32  # compute dtype; params stay in param_dtype
    param_dtype: torch.dtype = torch.float32
    # checkpoint every ``remat_every``-th block, keeping what ``remat_policy``
    # names (runtime/activation_checkpointing; None: full recompute)
    remat: bool = False
    remat_policy: Optional[str] = None
    remat_every: int = 1
    attention_backend: str = "xla"
    # the flash backend's backward policy (ops/cuda/flash_attention.POLICIES;
    # None: "lse"), read by no other backend; the engine's
    # ``attention.policy`` lands here
    attention_policy: Optional[str] = None
    # the JAX flash kernel's TPU block geometry; the Hopper kernels have their own tiles
    attention_blocks: Optional[str] = None
    attention_bias: bool = False  # Qwen2: biased q/k/v projections
    # Mistral: each token attends the last ``sliding_window`` positions
    # (training and the uncached forward; cached decode attends the whole cache)
    sliding_window: Optional[int] = None
    # >0: called with ``labels=``, return the chunked fused LM-head loss
    # (tokens per chunk) instead of [B, L, V] logits
    fused_head_loss_chunk: int = 0
    # Mixtral's MoE FFN (the JAX fields): every ``moe_layer_freq``-th layer
    # replaces its SwiGLU MLP with ``moe_num_experts`` experts, top ``moe_k``
    moe_num_experts: int = 0  # 0 = dense
    moe_layer_freq: int = 1
    moe_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_eval_capacity_factor: float = 2.0
    moe_min_capacity: int = 4
    moe_aux_loss_coef: float = 0.01
    # dispatch/combine route pin ("dense"|"sorted"); None resolves through
    # DS_MOE_ROUTE > the engine's "moe" block > "sorted" (moe/routing.py)
    moe_route: Optional[str] = None

    def __post_init__(self):
        for name, (off, where) in _LATER_SLICES.items():
            if getattr(self, name) != off:
                raise NotImplementedError(f"LlamaConfig.{name}={getattr(self, name)!r} belongs to "
                                          f"{where} of the PyTorch port")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(f"num_attention_heads {self.num_attention_heads} is not a multiple "
                             f"of num_key_value_heads {self.num_key_value_heads}")
        get_remat_policy(self.remat_policy)
        if self.attention_policy is not None:
            from deepspeed_tpu_torch.ops.cuda.flash_attention import check_policy
            check_policy(self.attention_policy)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    def is_moe_layer(self, i: int) -> bool:
        freq = max(self.moe_layer_freq, 1)
        return self.moe_num_experts > 0 and i % freq == freq - 1

    @property
    def moe_gate_draws(self) -> bool:
        """Whether training-mode gating draws noise: always for an MoE model
        (JAX's LLaMA MoE keeps the gate's RTS default, and top-2 samples its
        second choice)."""
        return self.moe_num_experts > 0


LLAMA_CONFIGS = {
    "test": dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128),
    "160m": dict(hidden_size=768, intermediate_size=2048, num_hidden_layers=12,
                 num_attention_heads=12, num_key_value_heads=12),
    "1b": dict(hidden_size=2048, intermediate_size=5504, num_hidden_layers=24,
               num_attention_heads=16, num_key_value_heads=16),
    "7b": dict(hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
               num_attention_heads=32, num_key_value_heads=32),
    # Mistral-7B: llama blocks + GQA(8) + 14336 MLP + 4096 sliding window
    "mistral-7b": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                       num_hidden_layers=32, num_attention_heads=32,
                       num_key_value_heads=8, max_position_embeddings=32768,
                       sliding_window=4096),
    "13b": dict(hidden_size=5120, intermediate_size=13824, num_hidden_layers=40,
                num_attention_heads=40, num_key_value_heads=40),
    # Mixtral-8x7B: llama blocks, top-2 of 8 SwiGLU experts per layer
    "mixtral-8x7b": dict(hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                         num_attention_heads=32, num_key_value_heads=8,
                         max_position_embeddings=4096, rope_theta=1e6,
                         moe_num_experts=8, moe_k=2),
    "mixtral-test": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=128, moe_num_experts=4, moe_k=2),
    # Qwen2 family: llama architecture + biased q/k/v projections
    "qwen2-7b": dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                     num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
                     max_position_embeddings=32768, rope_theta=1e6, attention_bias=True),
}


def get_llama_config(name: str, **overrides) -> LlamaConfig:
    return config_from(LLAMA_CONFIGS, LlamaConfig, name, **overrides)


def param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """State-dict key -> (shape, dtype) of a model built for ``cfg``."""
    e, h, hkv, d, i = (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim, cfg.intermediate_size)
    pd = cfg.param_dtype
    out = {"embed_tokens": ((cfg.vocab_size, e), pd)}
    for n in range(cfg.num_hidden_layers):
        p = f"layers_{n}"
        out[f"{p}.input_layernorm.weight"] = ((e,), pd)
        for name, heads in (("q_proj", h), ("k_proj", hkv), ("v_proj", hkv)):
            out[f"{p}.self_attn.{name}.kernel"] = ((e, heads, d), pd)
            if cfg.attention_bias:
                out[f"{p}.self_attn.{name}.bias"] = ((heads, d), pd)
        out[f"{p}.self_attn.o_proj.kernel"] = ((h, d, e), pd)
        out[f"{p}.post_attention_layernorm.weight"] = ((e,), pd)
        if cfg.is_moe_layer(n):
            x, moe = cfg.moe_num_experts, f"{p}.moe.deepspeed_moe"
            out[f"{moe}.gate.wg"] = ((e, x), torch.float32)
            out[f"{moe}.experts.deepspeed_experts.gate_proj.kernel"] = ((x, e, i), pd)
            out[f"{moe}.experts.deepspeed_experts.up_proj.kernel"] = ((x, e, i), pd)
            out[f"{moe}.experts.deepspeed_experts.down_proj.kernel"] = ((x, i, e), pd)
            continue
        out[f"{p}.mlp.gate_proj.kernel"] = ((e, i), pd)
        out[f"{p}.mlp.up_proj.kernel"] = ((e, i), pd)
        out[f"{p}.mlp.down_proj.kernel"] = ((i, e), pd)
    out["norm.weight"] = ((e,), pd)
    out["lm_head.kernel"] = ((e, cfg.vocab_size), pd)
    return out


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """RoPE on ``x`` [B, L, H, D] at ``positions`` [B or 1, L], half-split
    layout (the first D/2 dims rotate against the last D/2), in fp32,
    rounded back to x's dtype (JAX ``llama.py:131``)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta**(torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions.to(x.device)[..., None].float() * inv_freq  # [B, L, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.ones(cfg.hidden_size, dtype=cfg.param_dtype, device=device))

    def forward(self, x):
        cfg = self.cfg
        return rms_norm(x, self.weight.to(cfg.dtype), cfg.rms_norm_eps, cfg.dtype)


class LlamaAttention(nn.Module):
    """GQA attention with RoPE and the lockstep decode cache."""

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        e, d = cfg.hidden_size, cfg.head_dim
        self.q_proj = Dense(cfg, (e, cfg.num_attention_heads, d), 1, device, cfg.attention_bias)
        self.k_proj = Dense(cfg, (e, cfg.num_key_value_heads, d), 1, device, cfg.attention_bias)
        self.v_proj = Dense(cfg, (e, cfg.num_key_value_heads, d), 1, device, cfg.attention_bias)
        self.o_proj = Dense(cfg, (cfg.num_attention_heads, d, e), 2, device)

    def forward(self, x, cache: Optional[Dict[str, torch.Tensor]] = None, prefix: str = ""):
        cfg = self.cfg
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        causal, decode_lengths, window = True, None, cfg.sliding_window
        positions = cache_positions(cache, prefix, x.shape[1], x.device)
        q = rotary_embedding(q, positions, cfg.rope_theta)
        k = rotary_embedding(k, positions, cfg.rope_theta)
        if cache is not None:
            k, v, decode_lengths = cache_write(cache, prefix, k, v)
            causal, window = False, None
        n_rep = cfg.num_attention_heads // cfg.num_key_value_heads
        if n_rep > 1:  # GQA: every query head reads its group's kv head
            k = k.repeat_interleave(n_rep, dim=2)
            v = v.repeat_interleave(n_rep, dim=2)
        out = dot_product_attention(q, k, v, backend=cfg.attention_backend, causal=causal,
                                    decode_lengths=decode_lengths, window=window,
                                    policy=cfg.attention_policy if cfg.attention_backend == "flash"
                                    else None)
        return self.o_proj(out)


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        e, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(cfg, (e, i), 1, device)
        self.up_proj = Dense(cfg, (e, i), 1, device)
        self.down_proj = Dense(cfg, (i, e), 1, device)

    def stacked(self, num_experts: int) -> "StackedLlamaMLP":
        """``num_experts`` SwiGLU experts over ``[E, T, H]`` (the MoE
        experts, ``moe/sharded_moe.Experts``)."""
        return StackedLlamaMLP(self.gate_proj.cfg, num_experts, self.gate_proj.kernel.device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class StackedLlamaMLP(nn.Module):
    """``num_experts`` SwiGLU MLPs, ``[E, T, H] -> [E, T, H]``: one batched
    product per projection (gate, up, down). The experts take no dropout;
    ``generator`` is the ``Experts`` contract's and is ignored."""

    def __init__(self, cfg: LlamaConfig, num_experts: int, device):
        super().__init__()
        e, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = StackedDense(cfg, num_experts, e, i, device, bias=False)
        self.up_proj = StackedDense(cfg, num_experts, e, i, device, bias=False)
        self.down_proj = StackedDense(cfg, num_experts, i, e, device, bias=False)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        del generator
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):

    def __init__(self, cfg: LlamaConfig, device, use_moe: bool = False):
        super().__init__()
        self.use_moe = use_moe
        self.input_layernorm = RMSNorm(cfg, device)
        self.self_attn = LlamaAttention(cfg, device)
        self.post_attention_layernorm = RMSNorm(cfg, device)
        if use_moe:
            from deepspeed_tpu_torch.moe.layer import MoE
            self.moe = MoE(cfg.hidden_size, LlamaMLP(cfg, device), num_experts=cfg.moe_num_experts,
                           k=cfg.moe_k, capacity_factor=cfg.moe_capacity_factor,
                           eval_capacity_factor=cfg.moe_eval_capacity_factor,
                           min_capacity=cfg.moe_min_capacity, route=cfg.moe_route,
                           dtype=cfg.dtype, device=device)
        else:
            self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, cache=None, prefix="", gating_seed: Optional[int] = None,
                deterministic: bool = True):
        """``(x, l_aux)``: the layer's output and, for an MoE layer, its
        load-balancing loss (None for a dense layer). ``gating_seed`` seeds
        the gate's generator (an int, so that a checkpointed layer routes
        the same way when it is recomputed); ``deterministic=False`` is
        training-mode gating (train capacity factor, noise)."""
        x = x + self.self_attn(self.input_layernorm(x), cache, prefix)
        h = self.post_attention_layernorm(x)
        if not self.use_moe:
            return x + self.mlp(h), None
        gen = None
        if gating_seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(gating_seed)
        out, l_aux, _ = self.moe(h, deterministic=deterministic, gate_generator=gen)
        return x + out, l_aux


class LlamaForCausalLM(nn.Module):
    """LLaMA with an untied LM head. ``model(ids)`` -> logits ``[B, L, V]``
    in the compute dtype; ``model(ids, cache)`` runs the decode branch and
    updates ``cache`` in place."""

    #: the numbered blocks, which stream their own parameters under
    #: ``offload_param`` (``runtime/zero/param_offload.py``); the engine
    #: streams the other leaves
    streamed_block_prefixes = ("layers_",)

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        self.embed_tokens = nn.Parameter(torch.empty((cfg.vocab_size, cfg.hidden_size),
                                                     dtype=cfg.param_dtype, device=dev))
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layers_{i}", LlamaDecoderLayer(cfg, dev, cfg.is_moe_layer(i)))
        self.norm = RMSNorm(cfg, dev)
        self.lm_head = Dense(cfg, (cfg.hidden_size, cfg.vocab_size), 1, dev)
        if dev.type != "meta":  # a skeleton for kernel injection draws nothing
            self.reset_parameters(generator)

    @property
    def blocks(self):
        return [getattr(self, f"layers_{i}") for i in range(self.config.num_hidden_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init with the JAX model's distributions (normal 0.02 for
        ``embed_tokens``, every kernel and the MoE gates, zero biases, unit
        norm weights), from ``generator`` (a fresh one seeded 0 when
        None)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        dense_init()(self.embed_tokens, generator)
        for name, t in self.named_parameters():
            if name.endswith(".kernel") or name.endswith(".gate.wg"):
                dense_init()(t, generator)

    def cache_shapes(self, batch_size: int):
        """Decode-cache leaves (the JAX cache collection's paths): name ->
        (shape, dtype, device); the write index lives on the host."""
        cfg = self.config
        return decode_cache_shapes([f"layers_{i}/self_attn" for i in range(cfg.num_hidden_layers)],
                                   batch_size, cfg.max_position_embeddings, cfg.num_key_value_heads,
                                   cfg.head_dim, cfg.dtype, self.device)

    def forward(self, input_ids: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None, *,
                labels: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Logits [B, L, V] in the compute dtype, or with ``labels`` and
        ``fused_head_loss_chunk > 0`` the mean next-token loss (fp32
        scalar). A Mixtral model returns ``(logits, aux_total *
        moe_aux_loss_coef)`` instead of logits, and its fused-head loss
        includes that term in training. ``deterministic=False`` is
        training: an MoE model's gating draws from ``generator``; the dense
        model draws nothing."""
        cfg = self.config
        ids = input_ids.to(self.device)
        gate_seeds = [None] * cfg.num_hidden_layers
        if not deterministic and cfg.moe_gate_draws:
            if generator is None:
                raise ValueError("training an MoE model draws gating noise: pass a generator")
            gate_seeds = torch.randint(0, 2**62, (cfg.num_hidden_layers,), generator=generator,
                                       device=generator.device).tolist()
        x = embed_lookup(self.embed_tokens.to(cfg.dtype), ids)
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, block in enumerate(self.blocks):
            run = maybe_remat(block, cfg, i, enabled=cfg.remat and cache is None)
            x, l_aux = run(x, cache, f"layers_{i}/self_attn/", gate_seeds[i], deterministic)
            if l_aux is not None:
                aux_total = aux_total + l_aux
        x = self.norm(x)
        if labels is not None and cfg.fused_head_loss_chunk > 0:
            return fused_head_loss_output(x, self.lm_head.kernel.to(cfg.dtype),
                                          labels.to(self.device), cfg, aux_total, deterministic,
                                          vocab_major=False)
        logits = self.lm_head(x)  # logits stay in the compute dtype
        if cfg.moe_num_experts > 0:
            return logits, aux_total * cfg.moe_aux_loss_coef
        return logits
