"""MoQ, Mixture-of-Quantization training (counterpart of
``deepspeed_tpu/runtime/quantize.py``): the weights' bit width anneals during
training from ``start_bits`` to ``target_bits``, one bit at each period
crossing, each crossing doubling the next period, with optional mixed-fp16
blending and ternary (2-bit) and binary (1-bit) floors.

As in JAX the whole schedule is a function of the step counter: the
engine applies :func:`build_moq_transform`'s ``(params, step) -> params``
to the fp32 masters in every training forward, before the model's per-use
casts and outside its remat regions, with the straight-through estimator
(the quantized value carries the master's gradient). The bit width is
computed on the host in float32 as JAX computes it in the graph
(``floor(log2(t / period)) + 1`` crossings, with XLA's exp2 and log2), so
both packages quantize at the same bits at every step. Stochastic rounding draws from a
``torch.Generator`` (seeded from the step), not from JAX's threefry keys.
The :class:`Quantizer` class keeps the reference's host API.
"""

import logging
import math
from typing import Any, Callable, Dict, List, Optional

import torch

from deepspeed_tpu_torch.ops.quantizer.core import divisor_groups

logger = logging.getLogger(__name__)

#: JAX's stochastic-rounding seed (``PRNGKey(7919)``), folded with the step
_SR_SEED = 7919


def _grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    return x.reshape(groups, -1)


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


# XLA lowers float32 exp2 and log2 through exp and log: exp2(15) is
# 32767.984 and log2(8192) 12.999999 there. The schedule and the ranges
# follow JAX's values, not the exact ones, so that both packages quantize
# at the same bits with the same scales.
_LN2 = _f32(math.log(2.0))
_INV_LN2 = _f32(1.0 / math.log(2.0))


def _exp2(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x * _LN2)


def _log2(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) * _INV_LN2


def _highbit_fake_quant(flat: torch.Tensor, bits: float, symmetric: bool, stochastic: bool,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Group-wise fake quantization at ``bits`` (>= 3). ``noise`` injects
    stochastic rounding's uniform draws in [-0.5, 0.5)."""
    q_range = float(_exp2(_f32(bits)))
    g_min = flat.amin(dim=-1, keepdim=True)
    g_max = flat.amax(dim=-1, keepdim=True)
    p = 0.0
    if stochastic:
        p = noise if noise is not None else (
            torch.rand(flat.shape, generator=generator, dtype=flat.dtype, device=flat.device) - 0.5)
    if symmetric:
        scale = torch.clamp_min(2 * torch.maximum(g_min.abs(), g_max.abs()) / q_range, 1e-20)
        return torch.clamp(torch.round(flat / scale + p), -(q_range / 2), q_range / 2 - 1) * scale
    scale = torch.clamp_min((g_max - g_min) / q_range, 1e-20)
    zero = torch.round(g_min / scale) * scale
    return torch.clamp(torch.round((flat - zero) / scale + p), 0, q_range - 1) * scale + zero


def _ternary_fake_quant(flat: torch.Tensor) -> torch.Tensor:
    n = flat.shape[-1]
    m = flat.abs().sum(dim=-1, keepdim=True) / n
    thres = 0.7 * m
    mask = flat.abs() > thres
    alpha = (torch.where(mask, flat.abs(), torch.zeros((), dtype=flat.dtype, device=flat.device))
             .sum(dim=-1, keepdim=True) / mask.sum(dim=-1, keepdim=True).clamp_min(1))
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    return torch.where(flat > thres, alpha, zero) + torch.where(flat < -thres, -alpha, zero)


def _binary_fake_quant(flat: torch.Tensor) -> torch.Tensor:
    return torch.sign(flat) * flat.abs().mean(dim=-1, keepdim=True)


def _period_crossings(step, period: int):
    """``(t, crossings)`` in float32 for a step (int) or steps (a tensor),
    as JAX computes them: how many bit reductions have happened by
    ``step``, the first once ``step >= period``, each further one after a
    doubled period (``floor(log2(t / period)) + 1``)."""
    t = torch.clamp_min(torch.as_tensor(step).to(torch.float32), 1.0)
    return t, torch.where(t < period, torch.zeros_like(t), torch.floor(_log2(t / period)) + 1.0)


def moq_bits_at(step, start_bits: int, target_bits: int, period: int) -> torch.Tensor:
    """The schedule's bit width (float32) at ``step`` (an int, or a tensor
    of steps): ``start - crossings``, clamped to ``[target, start]``."""
    _, crossings = _period_crossings(step, period)
    return torch.clamp(start_bits - crossings, target_bits, start_bits)


def fake_quantize_stepped(x: torch.Tensor, step: int, *, start_bits: int, target_bits: int,
                          period: int, groups: int = 1, symmetric: bool = True,
                          stochastic: bool = False, mixed_fp16: bool = False,
                          change_ratio: float = 0.001,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fake-quantize ``x`` at the schedule's bit width for ``step``, with
    the straight-through estimator: the value is the quantized one, the
    gradient ``x``'s. ``noise`` (``[groups, size / groups]``, uniform in
    [-0.5, 0.5)) injects stochastic rounding's draws."""
    flat = _grouped(x.float(), groups)
    bits = float(moq_bits_at(step, start_bits, target_bits, period))
    with torch.no_grad():
        if target_bits <= 1 and bits <= 1.0:
            out = _binary_fake_quant(flat)
        elif target_bits <= 2 and bits <= 2.0:
            out = _ternary_fake_quant(flat)
        else:
            out = _highbit_fake_quant(flat, max(bits, 3.0), symmetric, stochastic, generator, noise)
        if mixed_fp16 and bits >= target_bits - 1:
            # the ratio re-arms to 1.0 at each bit reduction and decays a step
            t, crossings = _period_crossings(step, period)
            last = torch.where(crossings > 0, _exp2(crossings - 1.0) * period, _f32(0.0))
            ratio = torch.clamp_min(1.0 - _f32(change_ratio) * (t - last), 0.0).to(flat.device)
            out = ratio * flat + (1.0 - ratio) * out
        out = out.reshape(x.shape).to(x.dtype)
    return x + (out - x).detach()


def _resolve(config: Dict[str, Any]) -> Dict[str, Any]:
    """The ``quantize_training`` block's settings with JAX's defaults."""
    bits_cfg = config.get("quantize_bits", config)
    sched = config.get("quantize_schedule", {})
    algo = config.get("quantize_algo", {})
    mixed = config.get("fp16_mixed_quantize", {})
    return dict(
        start_bits=int(bits_cfg.get("start_bits", 16)),
        target_bits=int(bits_cfg.get("target_bits", 8)),
        period=int(config.get("quantize_period", sched.get("quantize_period", 100))),
        groups=int(config.get("quantize_groups", 1)),
        symmetric=algo.get("q_type", config.get("quantizer_type", "symmetric")) == "symmetric",
        stochastic=(algo.get("rounding", config.get("rounding", "nearest"))
                    not in ("nearest", "nearest_neighbor")),
        mixed_fp16=bool(mixed.get("enabled", False)),
        change_ratio=float(mixed.get("quantize_change_ratio", 0.001)),
        offset=int(config.get("schedule_offset", sched.get("schedule_offset", 0))))


def build_moq_transform(params: Dict[str, torch.Tensor], config: Dict[str, Any],
                        period_factors: Optional[Dict[str, float]] = None
                        ) -> Optional[Callable[[Dict[str, torch.Tensor], int], Dict[str, torch.Tensor]]]:
    """Resolve a ``quantize_training`` block against the named parameters
    -> ``(params, step) -> params`` (the quantized >= 2-D floating tensors
    by name; the others are left out, so ``functional_call`` keeps them),
    or None when the block is off or nothing qualifies.

    ``period_factors`` maps a parameter-name prefix (``h_3``) to a period
    multiplier: the eigenvalue modulation, high-curvature layers annealing
    slower."""
    if not config or not config.get("enabled", False):
        return None
    c = _resolve(config)
    names = [n for n, p in params.items() if p.dim() > 1 and p.is_floating_point()]
    if not names:
        return None
    logger.info(f"MoQ enabled: {c['start_bits']}->{c['target_bits']} bits, period={c['period']}, "
                f"groups={c['groups']}, {'symmetric' if c['symmetric'] else 'asymmetric'}, "
                f"{len(names)} tensors")

    def leaf_groups(numel: int) -> int:
        g = c["groups"]
        return g if numel % g == 0 else divisor_groups(numel, max(1, numel // max(g, 1)))

    def leaf_period(name: str) -> int:
        for prefix, factor in (period_factors or {}).items():
            if name == prefix or name.startswith(prefix + "."):
                return max(1, int(round(c["period"] * factor)))
        return c["period"]

    plan = {n: (leaf_groups(params[n].numel()), leaf_period(n)) for n in names}

    def transform(p: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        eff = max(int(step) - c["offset"], 0)
        gen = None
        out = {}
        for name, (groups, period) in plan.items():
            leaf = p[name]
            if c["stochastic"] and gen is None:
                gen = torch.Generator(device=leaf.device).manual_seed(_SR_SEED * 1_000_003 + int(step))
            out[name] = fake_quantize_stepped(
                leaf, eff, start_bits=c["start_bits"], target_bits=c["target_bits"], period=period,
                groups=groups, symmetric=c["symmetric"], stochastic=c["stochastic"],
                mixed_fp16=c["mixed_fp16"], change_ratio=c["change_ratio"], generator=gen)
        return out

    transform.names = tuple(names)
    return transform


class Quantizer:
    """The reference's host API (``runtime/quantize.py`` ``Quantizer``): a
    mutable per-call schedule with ``q_period`` doubling and the
    eigenvalue factor. ``parameter_group`` is a list of lists of dicts with
    keys ``value`` (a tensor), ``start_bits``, ``target_bits``,
    ``q_period`` and optionally ``name``."""

    def __init__(self, q_groups=1, q_mixed_fp16=False, q_change_ratio=0.01, q_type="symmetric",
                 q_rounding="nearest", q_verbose=False, q_eigenvalue=False,
                 use_quantizer_kernel=False, layer_num=0):
        self.q_groups = q_groups
        self.q_mixed_fp16 = q_mixed_fp16
        self.q_change_ratio = q_change_ratio
        self.q_type = q_type
        self.q_rounding = q_rounding
        self.q_verbose = q_verbose
        self.q_eigenvalue = q_eigenvalue
        self.use_quantizer_kernel = use_quantizer_kernel
        self.layer_num = layer_num
        self.qsteps = 0
        self.quantize_real_ratio = 1.0

    def step(self):
        self.qsteps += 1

    def update_fp16_ratio(self):
        if self.q_mixed_fp16:
            self.quantize_real_ratio = max(0.0, self.quantize_real_ratio - self.q_change_ratio)

    def quantize(self, parameter_group: List[List[dict]], overflow: bool, eigenvalue_enabled: bool,
                 block_eigenvalue: Optional[dict] = None):
        if overflow and not eigenvalue_enabled:
            return
        self.step()
        self.update_fp16_ratio()
        for group in parameter_group:
            for p in group:
                if torch.as_tensor(p["value"]).dim() <= 1:
                    continue
                eig = (block_eigenvalue or {}).get(p.get("name"), None)
                factor = 1 + math.floor(eig * 4) if eig is not None else 1
                p["value"] = self._compute_quantization(p, factor)

    def _compute_quantization(self, p: dict, factor: int = 1):
        if p["start_bits"] != p["target_bits"] and self.qsteps >= p["q_period"]:
            self.quantize_real_ratio = 1.0
            p["q_period"] = (p["q_period"] << 1) * factor
            p["start_bits"] -= 1
            if self.q_verbose:
                logger.info(f"MoQ: bits={p['start_bits']} step={self.qsteps} period={p['q_period']}")
        assert p["start_bits"] >= p["target_bits"], \
            "Quantization bit is lower than target precision bits!"
        x = torch.as_tensor(p["value"])
        flat = _grouped(x.float(), self.q_groups)
        bits = p["start_bits"]
        if bits >= 3:
            out = _highbit_fake_quant(flat, float(bits), self.q_type == "symmetric",
                                      self.q_rounding not in ("nearest", "nearest_neighbor"),
                                      torch.Generator(device=x.device).manual_seed(self.qsteps))
        elif bits == 2:
            out = _ternary_fake_quant(flat)
        else:
            out = _binary_fake_quant(flat)
        if self.q_mixed_fp16 and bits >= p["target_bits"] - 1:
            out = self.quantize_real_ratio * flat + (1 - self.quantize_real_ratio) * out
        return out.reshape(x.shape).to(x.dtype)
