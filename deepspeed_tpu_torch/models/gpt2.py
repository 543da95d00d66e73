"""GPT-2 for serving and training (counterpart of
``deepspeed_tpu/models/gpt2.py``).

The parameter layouts are the JAX package's, so weights carry across with
no transposes: fused QKV ``[E, 3, H, D]`` with bias ``[3, H, D]``,
attention-out ``[H, D, E]``, MLP ``[E, 4E]`` and ``[4E, E]``, tied ``wte
[V, E]`` and ``wpe [P, E]``. Module names follow the JAX scopes (``h_0``,
``attn``, ``c_attn``...), so a state-dict key is the JAX path with dots and
without flax's inner ``LayerNorm_0`` scope.

The decode branch of :class:`SelfAttention` takes the cache from
``models/common.init_cache`` (lockstep ``generate``: scalar ``cache_index``)
or ``inference/serving/programs.make_slot_cache`` (serving: one write
position per slot, int8 KV codes and scales by default) and updates it in
place.

For training, ``model(ids, labels=..., deterministic=False, generator=g)``
applies dropout (embedding, attention probabilities on the ``"xla"``
backend, attention output, MLP), checkpoints blocks under ``remat``
(``models/common.maybe_remat``), and with ``fused_head_loss_chunk > 0``
returns the chunked fused LM-head loss instead of logits. Every floating
parameter is rounded to the compute dtype where it is used, as the JAX
engine casts the whole parameter tree before ``apply``, so fp32 master
weights train with bf16 compute.

With ``moe_num_experts > 0`` every ``moe_layer_freq``-th block (layers
``freq - 1``, ``2 freq - 1``...) runs an MoE FFN of ``moe_num_experts``
stacked MLP experts (``moe/``) instead of its MLP. The model then sums the
blocks' load-balancing losses: the fused head adds ``aux_total *
moe_aux_loss_coef`` to its loss in training, and the logits forward returns
``(logits, aux_total * moe_aux_loss_coef)``. Training-mode gating draws its
noise from a generator per block, seeded from the caller's generator, so a
checkpointed block routes the same way when it is recomputed. An MoE model
decodes against both caches with eval-mode gating; its weight-quantized
serving view builds the attention projections and the dense blocks' MLP on
K2 and keeps every MoE leaf (experts, gate, PR-MoE residual and
coefficient) in the serving dtype, as the JAX quantizer's skip list leaves
every leaf under ``moe`` in fp. The pipeline adapters belong to a later
slice.

``remat_policy`` names what a checkpointed block keeps
(``runtime/activation_checkpointing``); ``attention_policy`` is the flash
backward's (``"lse"`` or ``"recompute"``). ``attn_fused_qkv`` and
``attn_fused_out`` are taken and inert: in JAX they choose how XLA's
program contracts the same parameters, and torch runs either form as the
same product. With ``progressive_layer_drop`` and a
``pld_theta`` from the engine, training keeps each sublayer (attention,
MLP or MoE) of block i with probability ``1 - (i + 1) / n_layer * (1 -
theta)`` (JAX ``gpt2.py:536-542``), drawn from the caller's generator, and
scales a kept one by ``1 / keep``; a dropped MoE sublayer adds no
load-balancing loss. ``last_pld_keep`` holds the last draw ([n_layer, 2]).
"""

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.device import DeviceLike, host_to_device, resolve_device
from deepspeed_tpu_torch.models.common import (LayerNorm, StackedDense, config_from,  # noqa: F401
                                               cross_entropy_loss, decode_cache_shapes, dense_init,
                                               dropout, embed_lookup, fused_head_loss_output,
                                               maybe_remat, pld_draws, pld_gate)
from deepspeed_tpu_torch.ops.cuda.quant_matmul import quant_dense_general
from deepspeed_tpu_torch.ops.quantizer.core import divisor_groups, quantize_lastaxis
from deepspeed_tpu_torch.ops.quantizer.weights import quant_bits
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import get_remat_policy

#: config fields of the JAX model that belong to later slices of the port,
#: with the value that means "off" and the slice
_LATER_SLICES = {"attention_blocks": (None, "attention-tuning")}


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    # applied in training only (forward(deterministic=False)); attention
    # dropout needs the "xla" backend
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    dtype: torch.dtype = torch.float32  # compute dtype; params stay in param_dtype
    param_dtype: torch.dtype = torch.float32
    attention_backend: str = "xla"
    # served weight dtype this model is built for ("int8"|"int4"); None
    # keeps fp projections. Set by the serving scheduler's quantized view.
    serve_weight_dtype: Optional[str] = None
    # target rows per quantization group along the contraction axis
    serve_weight_group_size: int = 64
    # checkpoint every ``remat_every``-th block, keeping what
    # ``remat_policy`` names (runtime/activation_checkpointing; None: full
    # recompute)
    remat: bool = False
    remat_every: int = 1
    remat_policy: Optional[str] = None
    # JAX's program forms of the two attention projections: inert here (one
    # product either way over the same parameters), taken so JAX's configs
    # and ``program`` blocks load
    attn_fused_qkv: bool = True
    attn_fused_out: bool = True
    # the flash backend's backward policy (ops/cuda/flash_attention.POLICIES;
    # None: "lse"), read by no other backend; the engine's
    # ``attention.policy`` lands here
    attention_policy: Optional[str] = None
    # >0: called with ``labels=``, return the chunked fused LM-head loss
    # (tokens per chunk) instead of [B, L, V] logits
    fused_head_loss_chunk: int = 0
    # the JAX flash kernel's TPU block geometry; the Hopper kernels have
    # their own tiles
    attention_blocks: Optional[str] = None
    progressive_layer_drop: bool = False
    # MoE (the JAX fields): every ``moe_layer_freq``-th block is an MoE FFN
    moe_num_experts: int = 0  # 0 = dense model
    moe_layer_freq: int = 2
    moe_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_eval_capacity_factor: float = 2.0
    moe_min_capacity: int = 4
    moe_aux_loss_coef: float = 0.01
    moe_noisy_gate_policy: Optional[str] = None
    moe_use_residual: bool = False
    moe_drop_tokens: bool = True
    moe_use_rts: bool = True
    # dispatch/combine route pin ("dense"|"sorted"); None resolves through
    # DS_MOE_ROUTE > the engine's "moe" block > "sorted" (moe/routing.py)
    moe_route: Optional[str] = None

    def __post_init__(self):
        for name, (off, where) in _LATER_SLICES.items():
            if getattr(self, name) != off:
                raise NotImplementedError(f"GPT2Config.{name}={getattr(self, name)!r} belongs to the "
                                          f"{where} slice of the PyTorch port")
        if self.serve_weight_dtype not in (None, "fp", "int8", "int4"):
            raise ValueError(f"unknown serve_weight_dtype {self.serve_weight_dtype!r}")
        get_remat_policy(self.remat_policy)
        if self.attention_policy is not None:
            from deepspeed_tpu_torch.ops.cuda.flash_attention import check_policy
            check_policy(self.attention_policy)

    @property
    def head_dim(self):
        return self.n_embd // self.n_head

    def is_moe_layer(self, i: int) -> bool:
        return self.moe_num_experts > 0 and i % self.moe_layer_freq == self.moe_layer_freq - 1

    @property
    def moe_gate_draws(self) -> bool:
        """Whether training-mode gating draws noise (RTS, a noisy gate or
        top-2; the JAX gate's ``make_rng`` condition)."""
        return self.moe_num_experts > 0 and (self.moe_use_rts or self.moe_k == 2 or
                                             self.moe_noisy_gate_policy not in (None, "None"))

    @property
    def weight_bits(self) -> Optional[int]:
        return None if self.serve_weight_dtype in (None, "fp") else quant_bits(self.serve_weight_dtype)


GPT2_CONFIGS = {
    # tiny config for unit tests
    "test": dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=4),
    "125m": dict(n_embd=768, n_layer=12, n_head=12),
    "350m": dict(n_embd=1024, n_layer=24, n_head=16),
    "760m": dict(n_embd=1536, n_layer=24, n_head=16),
    "xl": dict(n_embd=1600, n_layer=48, n_head=25),
}


def get_gpt2_config(name: str, **overrides) -> GPT2Config:
    return config_from(GPT2_CONFIGS, GPT2Config, name, **overrides)


def _projection_shapes(cfg: GPT2Config, kshape, n_contract) -> Dict[str, Tuple[tuple, torch.dtype]]:
    bits = cfg.weight_bits
    if bits is None:
        return {"kernel": (tuple(kshape), cfg.param_dtype)}
    qshape = list(kshape)
    if bits == 4:
        qshape[n_contract - 1] //= 2  # packed contraction axis
    k = math.prod(kshape[:n_contract])
    n = math.prod(kshape[n_contract:])
    groups = divisor_groups(k, cfg.serve_weight_group_size)
    return {"kernel": (tuple(qshape), torch.int8), "kernel_scale": ((groups, n), torch.float32)}


def param_shapes(cfg: GPT2Config) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """State-dict key -> (shape, dtype) of a model built for ``cfg``."""
    e, h, d = cfg.n_embd, cfg.n_head, cfg.head_dim
    pd = cfg.param_dtype
    out = {"wte": ((cfg.vocab_size, e), pd), "wpe": ((cfg.n_positions, e), pd)}

    def add(prefix, shapes):
        out.update({f"{prefix}.{k}": v for k, v in shapes.items()})

    norm = {"scale": ((e,), pd), "bias": ((e,), pd)}
    for i in range(cfg.n_layer):
        p = f"h_{i}"
        add(f"{p}.ln_1", norm)
        add(f"{p}.attn.c_attn", _projection_shapes(cfg, (e, 3, h, d), 1))
        add(f"{p}.attn.c_attn", {"bias": ((3, h, d), pd)})
        add(f"{p}.attn.c_proj", _projection_shapes(cfg, (h, d, e), 2))
        add(f"{p}.attn.c_proj", {"bias": ((e,), pd)})
        add(f"{p}.ln_2", norm)
        mlp = {"c_fc.kernel": ((e, 4 * e), pd), "c_fc.bias": ((4 * e,), pd),
               "c_proj.kernel": ((4 * e, e), pd), "c_proj.bias": ((e,), pd)}
        if cfg.is_moe_layer(i):
            n = cfg.moe_num_experts
            add(f"{p}.moe.deepspeed_moe.gate", {"wg": ((e, n), torch.float32)})
            add(f"{p}.moe.deepspeed_moe.experts.deepspeed_experts",
                {k: ((n,) + shape, dt) for k, (shape, dt) in mlp.items()})
            if cfg.moe_use_residual:
                add(f"{p}.moe.mlp.residual_mlp", mlp)
                add(f"{p}.moe.coefficient", {"kernel": ((e, 2), torch.float32),
                                             "bias": ((2,), torch.float32)})
            continue
        add(f"{p}.mlp.c_fc", _projection_shapes(cfg, (e, 4 * e), 1))
        add(f"{p}.mlp.c_fc", {"bias": ((4 * e,), pd)})
        add(f"{p}.mlp.c_proj", _projection_shapes(cfg, (4 * e, e), 1))
        add(f"{p}.mlp.c_proj", {"bias": ((e,), pd)})
    add("ln_f", norm)
    return out


class _Projection(nn.Module):
    """A projection over a JAX-layout kernel contracting the input's
    trailing ``n_contract`` dims: fp, or int8/int4 codes plus per-group
    scales when the config is built for quantized serving (dequantisation
    fused into the GEMM, kernel K2)."""

    def __init__(self, cfg: GPT2Config, kshape, bias_shape, n_contract: int, device):
        super().__init__()
        self.cfg = cfg
        self.n_contract = n_contract
        self.bits = cfg.weight_bits
        for name, (shape, dtype) in _projection_shapes(cfg, kshape, n_contract).items():
            t = torch.zeros(shape, dtype=dtype, device=device)
            if dtype.is_floating_point and name == "kernel":
                self.kernel = nn.Parameter(t)
            else:
                self.register_buffer(name, t)
        self.bias = nn.Parameter(torch.zeros(bias_shape, dtype=cfg.param_dtype, device=device))

    def forward(self, x):
        cfg = self.cfg
        x = x.to(cfg.dtype)
        nc = self.n_contract
        if self.bits is not None:
            out = quant_dense_general(x, self.kernel, self.kernel_scale, bits=self.bits,
                                      n_contract=nc)
        else:
            k = math.prod(x.shape[x.dim() - nc:])
            out_dims = self.kernel.shape[nc:]
            out = x.reshape(*x.shape[:x.dim() - nc], k) @ self.kernel.to(cfg.dtype).reshape(k, -1)
            out = out.reshape(*x.shape[:x.dim() - nc], *out_dims)
        return out + self.bias.to(cfg.dtype)


class QKVProj(_Projection):
    """Fused QKV projection over the ``[E, 3, H, D]`` kernel."""

    def __init__(self, cfg, device):
        super().__init__(cfg, (cfg.n_embd, 3, cfg.n_head, cfg.head_dim),
                         (3, cfg.n_head, cfg.head_dim), 1, device)

    def forward(self, x):
        qkv = super().forward(x)
        return qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]


class AttnOutProj(_Projection):
    """Attention-output projection over the ``[H, D, E]`` kernel."""

    def __init__(self, cfg, device):
        super().__init__(cfg, (cfg.n_head, cfg.head_dim, cfg.n_embd), (cfg.n_embd,), 2, device)


class QuantDense(_Projection):
    """Dense ``[in, out]`` projection (fp or quantized)."""

    def __init__(self, cfg, in_features, features, device):
        super().__init__(cfg, (in_features, features), (features,), 1, device)


class MLP(nn.Module):
    """The GPT-2 MLP, or with ``num_experts`` that many stacked copies over
    ``[E, T, E_model]`` (the MoE experts, ``stacked``)."""

    def __init__(self, cfg, device, num_experts: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        if num_experts is None:
            self.c_fc = QuantDense(cfg, cfg.n_embd, 4 * cfg.n_embd, device)
            self.c_proj = QuantDense(cfg, 4 * cfg.n_embd, cfg.n_embd, device)
        else:
            self.c_fc = StackedDense(cfg, num_experts, cfg.n_embd, 4 * cfg.n_embd, device)
            self.c_proj = StackedDense(cfg, num_experts, 4 * cfg.n_embd, cfg.n_embd, device)

    def stacked(self, num_experts: int) -> "MLP":
        return MLP(self.cfg, self.c_fc.bias.device, num_experts)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = self.c_proj(torch.nn.functional.gelu(self.c_fc(x), approximate="tanh"))
        return dropout(h, self.cfg.dropout, generator)


class _SlotWrite(NamedTuple):
    """Where one decode call writes into the KV pools, computed on the host
    from the write positions: flat destination rows (slot * P + position)
    of the in-range writes, their source rows (slot * l + token), and the
    resulting per-slot lengths."""
    dst: torch.Tensor
    src: torch.Tensor
    lengths: torch.Tensor


def _slot_write(idx: torch.Tensor, l: int, capacity: int, device, plans: dict) -> _SlotWrite:
    """The write plan for per-slot positions ``idx`` [S] (host), shared by
    every layer of one forward through ``plans``. Positions outside
    ``[0, capacity)`` — a parked slot's sentinel — drop, as the JAX
    scatter drops out-of-bounds updates."""
    key = (tuple(idx.tolist()), l)
    plan = plans.get(key)
    if plan is None:
        start = idx.numpy().astype(np.int64)
        pos = start[:, None] + np.arange(l)[None, :]
        b, t = np.nonzero((pos >= 0) & (pos < capacity))
        plan = plans[key] = _SlotWrite(
            dst=host_to_device(b * capacity + pos[b, t], device),
            src=host_to_device(b * l + t, device),
            lengths=host_to_device((start + l).astype(np.int32), device))
    return plan


def _kv_quantize(vals):
    """Per-(slot, token, head) symmetric int8 KV quantization: (codes
    [b, l, h, d] int8, scales [b, l, h, 1] in the KV dtype)."""
    codes, scale = quantize_lastaxis(vals, num_bits=8)
    return codes, scale.to(vals.dtype)


def _put_rows(pool: torch.Tensor, plan: _SlotWrite, vals: torch.Tensor) -> None:
    """In-place row write into a [S, P, ...] pool (JAX wrote a new pool)."""
    rows = vals.reshape(-1, *vals.shape[2:]).index_select(0, plan.src)
    pool.view(-1, *pool.shape[2:]).index_copy_(0, plan.dst, rows.to(pool.dtype))


class SelfAttention(nn.Module):

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.c_attn = QKVProj(cfg, device)
        self.c_proj = AttnOutProj(cfg, device)

    def forward(self, x, cache: Optional[Dict[str, torch.Tensor]] = None, prefix: str = "",
                plans: Optional[dict] = None, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        q, k, v = self.c_attn(x)
        causal, decode_lengths, k_scale, v_scale = True, None, None, None
        if cache is not None:
            b, l = x.shape[0], x.shape[1]
            pool_k, pool_v = cache[prefix + "cached_key"], cache[prefix + "cached_value"]
            capacity = pool_k.shape[1]
            kv_q = pool_k.dtype == torch.int8
            idx = cache[prefix + "cache_index"]
            if idx.dim():
                # per-slot serving cache: every slot appends at its own
                # position; a parked slot's sentinel position drops its writes
                plan = _slot_write(idx, l, capacity, x.device, plans if plans is not None else {})
                if kv_q:
                    k_w, k_s = _kv_quantize(k)
                    v_w, v_s = _kv_quantize(v)
                    _put_rows(cache[prefix + "cached_key_scale"], plan, k_s)
                    _put_rows(cache[prefix + "cached_value_scale"], plan, v_s)
                else:
                    k_w, v_w = k, v
                _put_rows(pool_k, plan, k_w)
                _put_rows(pool_v, plan, v_w)
                decode_lengths = plan.lengths
            else:
                if kv_q:
                    raise NotImplementedError("int8 KV pools are a per-slot serving cache "
                                              "(make_slot_cache(kv_quant=True)); lockstep "
                                              "decode uses fp KV")
                start = int(idx)
                if start + l > capacity:
                    raise ValueError(f"decode write [{start}, {start + l}) exceeds the cache "
                                     f"capacity {capacity}")
                pool_k[:, start:start + l] = k
                pool_v[:, start:start + l] = v
                decode_lengths = torch.full((b,), start + l, dtype=torch.int32, device=x.device)
            idx += l  # in place: the cache dict is the caller's
            k, v = pool_k, pool_v
            if kv_q:
                # dequantize-on-read: the pool holds codes. The flash backend
                # hands codes and scales to K3, which dequantises as it
                # reads; other backends read the dequantised pool
                k_scale = cache[prefix + "cached_key_scale"]
                v_scale = cache[prefix + "cached_value_scale"]
                if cfg.attention_backend != "flash":
                    k, v = k.to(q.dtype) * k_scale, v.to(q.dtype) * v_scale
                    k_scale = v_scale = None
            causal = False
        rate = cfg.dropout if generator is not None else 0.0
        attn_out = dot_product_attention(q, k, v, backend=cfg.attention_backend, causal=causal,
                                         decode_lengths=decode_lengths, dropout_rate=rate,
                                         generator=generator, k_scale=k_scale, v_scale=v_scale,
                                         policy=cfg.attention_policy if cfg.attention_backend == "flash"
                                         else None)
        return dropout(self.c_proj(attn_out), rate, generator)


class Block(nn.Module):

    def __init__(self, cfg, device, use_moe: bool = False):
        super().__init__()
        self.use_moe = use_moe
        self.ln_1 = LayerNorm(cfg, cfg.n_embd, "layer_norm_epsilon", device)
        self.attn = SelfAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg, cfg.n_embd, "layer_norm_epsilon", device)
        if use_moe:
            from deepspeed_tpu_torch.moe.layer import MoE

            # every MoE leaf stays fp in a quantized serving view
            fp_cfg = dataclasses.replace(cfg, serve_weight_dtype=None)
            self.moe = MoE(cfg.n_embd, MLP(fp_cfg, device), num_experts=cfg.moe_num_experts,
                           k=cfg.moe_k, capacity_factor=cfg.moe_capacity_factor,
                           eval_capacity_factor=cfg.moe_eval_capacity_factor,
                           min_capacity=cfg.moe_min_capacity, use_residual=cfg.moe_use_residual,
                           noisy_gate_policy=cfg.moe_noisy_gate_policy,
                           drop_tokens=cfg.moe_drop_tokens, use_rts=cfg.moe_use_rts,
                           route=cfg.moe_route, dtype=cfg.dtype, device=device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x, cache=None, prefix="", plans=None, dropout_seed: Optional[int] = None,
                gating_seed: Optional[int] = None, deterministic: bool = True,
                pld_keep: Optional[float] = None, pld_mask: Optional[torch.Tensor] = None):
        """``(x, l_aux)``: the block's output and, for an MoE block, its
        load-balancing loss (None for a dense block). ``dropout_seed`` and
        ``gating_seed`` seed this block's dropout and gating generators
        (None: no draws). Ints and not generators, so that a checkpointed
        block draws the same masks and routes the same way when it is
        recomputed. ``deterministic=False`` is training-mode gating (train
        capacity factor, noise). With ``pld_keep`` (the keep probability)
        and ``pld_mask`` (bool [2]: attention, then the MLP or MoE), a
        sublayer whose flag is False adds nothing and a kept one adds its
        output over ``pld_keep``."""
        gen = None
        if dropout_seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(dropout_seed)
        x = x + pld_gate(self.attn(self.ln_1(x), cache, prefix, plans, gen), pld_keep, pld_mask, 0)
        if not self.use_moe:
            return x + pld_gate(self.mlp(self.ln_2(x), gen), pld_keep, pld_mask, 1), None
        gate_gen = None
        if gating_seed is not None:
            gate_gen = torch.Generator(device=x.device).manual_seed(gating_seed)
        out, l_aux, _ = self.moe(self.ln_2(x), deterministic=deterministic,
                                 gate_generator=gate_gen, generator=gen)
        if pld_mask is not None:
            # a dropped expert layer pushes no balancing gradient into its router
            l_aux = torch.where(pld_mask[1], l_aux, torch.zeros_like(l_aux))
        return x + pld_gate(out, pld_keep, pld_mask, 1), l_aux


class GPT2LMHeadModel(nn.Module):
    """GPT-2 with the tied-embedding LM head. ``model(ids)`` -> logits
    ``[B, L, V]`` in the compute dtype; ``model(ids, cache)`` runs the
    decode branch and updates ``cache`` in place."""

    #: the numbered blocks, which stream their own parameters under
    #: ``offload_param`` (``runtime/zero/param_offload.py``); the engine
    #: streams the other leaves
    streamed_block_prefixes = ("h_",)

    def __init__(self, config: GPT2Config, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        self.wte = nn.Parameter(torch.empty((cfg.vocab_size, cfg.n_embd), dtype=cfg.param_dtype,
                                            device=dev))
        self.wpe = nn.Parameter(torch.empty((cfg.n_positions, cfg.n_embd), dtype=cfg.param_dtype,
                                            device=dev))
        for i in range(cfg.n_layer):
            setattr(self, f"h_{i}", Block(cfg, dev, cfg.is_moe_layer(i)))
        self.ln_f = LayerNorm(cfg, cfg.n_embd, "layer_norm_epsilon", dev)
        self.last_pld_keep: Optional[torch.Tensor] = None
        if dev.type != "meta":  # a skeleton for kernel injection draws nothing
            self.reset_parameters(generator)

    @property
    def blocks(self):
        return [getattr(self, f"h_{i}") for i in range(self.config.n_layer)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init with the JAX model's distributions (normal 0.02 for
        kernels, MoE gates and ``wte``, 0.01 for ``wpe``; zero biases, unit
        norm scales; the PR-MoE coefficient normal with std fan_in^-1/2,
        flax's lecun_normal without its truncation), from ``generator`` (a
        fresh one seeded 0 when None)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        dense_init()(self.wte, generator)
        dense_init(0.01)(self.wpe, generator)
        for name, t in self.named_parameters():
            if name.endswith(".coefficient.kernel"):
                dense_init(t.shape[0] ** -0.5)(t, generator)
            elif name.endswith(".kernel") or name.endswith(".gate.wg"):
                dense_init()(t, generator)

    def cache_shapes(self, batch_size: int):
        """Decode-cache leaves: name -> (shape, dtype, device)."""
        cfg = self.config
        return decode_cache_shapes([f"h_{i}/attn" for i in range(cfg.n_layer)], batch_size,
                                   cfg.n_positions, cfg.n_head, cfg.head_dim, cfg.dtype, self.device,
                                   position_index=True)

    def forward(self, input_ids: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None, *,
                labels: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                pld_theta: Optional[float] = None):
        """Logits [B, L, V] in the compute dtype, or with ``labels`` and
        ``fused_head_loss_chunk > 0`` the mean next-token loss (fp32
        scalar). An MoE model returns ``(logits, aux_total *
        moe_aux_loss_coef)`` instead of logits, and its fused-head loss
        includes that term in training. ``deterministic=False`` is training:
        dropout, training-mode gating and, under ``progressive_layer_drop``
        with a ``pld_theta``, the sublayer drops draw from ``generator``."""
        cfg = self.config
        ids = input_ids.to(self.device)
        seq_len = ids.shape[1]
        seeds = [None] * (cfg.n_layer + 1)
        gate_seeds = [None] * cfg.n_layer
        if not deterministic and (cfg.dropout > 0.0 or cfg.moe_gate_draws):
            if generator is None:
                raise ValueError("training with dropout or MoE gating noise needs a generator")
            if cfg.dropout > 0.0:
                seeds = torch.randint(0, 2**62, (cfg.n_layer + 1,), generator=generator,
                                      device=generator.device).tolist()
            if cfg.moe_gate_draws:
                gate_seeds = torch.randint(0, 2**62, (cfg.n_layer,), generator=generator,
                                           device=generator.device).tolist()
        keeps = [None] * cfg.n_layer
        pld = None
        if cfg.progressive_layer_drop and pld_theta is not None and not deterministic:
            if generator is None:
                raise ValueError("progressive layer drop in training needs a generator")
            keeps, pld = pld_draws(cfg.n_layer, pld_theta, generator, self.device)
            self.last_pld_keep = pld
        wte = self.wte.to(cfg.dtype)  # once: both uses of the tied table share its gradient
        x = embed_lookup(wte, ids)
        plans = None
        if cache is not None:
            pidx = cache["position_index"]
            if pidx.dim():
                # per-slot serving cache: [S] positions, clipped so parked
                # slots' sentinel positions stay in the table (their rows are dead)
                positions = (pidx[:, None] + torch.arange(seq_len)[None, :]).clamp(0, cfg.n_positions - 1)
                x = x + self.wpe[host_to_device(positions, self.device)].to(cfg.dtype)
            else:
                start = int(pidx)
                if start + seq_len > cfg.n_positions:
                    raise ValueError(f"positions [{start}, {start + seq_len}) exceed n_positions "
                                     f"{cfg.n_positions}")
                x = x + self.wpe[start:start + seq_len].to(cfg.dtype)[None]
            pidx += seq_len  # in place
            plans = {}
        else:
            x = x + self.wpe[:seq_len].to(cfg.dtype)
        if seeds[-1] is not None:
            x = dropout(x, cfg.dropout, torch.Generator(device=x.device).manual_seed(seeds[-1]))
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, block in enumerate(self.blocks):
            run = maybe_remat(block, cfg, i, enabled=cfg.remat and cache is None)
            x, l_aux = run(x, cache, f"h_{i}/attn/", plans, seeds[i], gate_seeds[i],
                           deterministic, keeps[i], None if pld is None else pld[i])
            if l_aux is not None:
                aux_total = aux_total + l_aux
        x = self.ln_f(x)
        if labels is not None and cfg.fused_head_loss_chunk > 0:
            return fused_head_loss_output(x, wte, labels.to(self.device), cfg, aux_total,
                                          deterministic)
        # tied LM head; logits stay in the compute dtype (JAX gpt2.py:559)
        logits = x @ wte.t()
        if cfg.moe_num_experts > 0:
            return logits, aux_total * cfg.moe_aux_loss_coef
        return logits
