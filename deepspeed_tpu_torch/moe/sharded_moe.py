"""Top-1/top-2 gating and the MoE layer on one device (counterpart of
``deepspeed_tpu/moe/sharded_moe.py``).

What carries over from the JAX package unchanged:

* **Static capacity** from the static token count (:func:`_capacity`,
  :func:`_gate_capacity`); ``drop_tokens=False`` means the worst case,
  ``capacity = tokens``.
* **One decision core per k** (:func:`_top1_decisions`,
  :func:`_top2_decisions`) shared by the dense route (``[S,E,C]`` tensors,
  :func:`top1gating`/:func:`top2gating`) and the sorted route (compact
  per-token-copy fields, :func:`top1routing`/:func:`top2routing`), so both
  routes make the same choices.
* **Two dispatch/combine routes** (``moe/routing.py``): the dense einsums,
  kept as the port's own check of the sorted route, and the sorted row
  permutation (K5, ``ops/cuda/moe_dispatch.py``).

What the port does its own way:

* **Random draws are inputs.** The JAX gate splits a ``"gating"`` rng key
  inside the call. Here the decision cores take the draws as tensors (the
  RTS uniforms, the Gumbel noise of RSample and of top-2's second choice)
  and :class:`TopKGate` draws them, with the Jitter factors, from a
  ``torch.Generator`` the caller seeds (:meth:`TopKGate.draw_noise`). The
  cores are then deterministic functions, so a test can feed them the JAX
  draws, and a checkpointed block that reseeds its generator routes the
  same way when it is recomputed.
* **Ties keep the lowest index.** Without RTS the capacity priority is the
  0/1 routing mask, full of ties; ``jax.lax.top_k`` keeps the lowest token
  indices among equal values, and ``torch.topk`` promises no order among
  ties on CUDA, so :func:`_keep_top_capacity` uses a stable descending sort.
* **One token group.** There is no mesh: tokens form one group (the JAX
  ``_num_groups`` without a topology), and no sharding constraint or
  all-to-all exists. Expert parallelism over several cards is a later slice.
* **Load statistics** (``exp_counts``, ``kept_counts``, ``routed_counts``,
  ``capacity_slots``) are attributes of :class:`MOELayer` after each call,
  where the JAX layer sowed them into ``"intermediates"``.

Each stage of a layer's forward runs in a ``torch.profiler.record_function``
range (``moe_gate``: gating and the index maps; ``moe_dispatch``;
``moe_experts``; ``moe_combine``), the port's counterpart of the JAX
package's MoE timer names, so a profile can split an MoE layer's time.
"""

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from deepspeed_tpu_torch.moe.routing import resolve_route
from deepspeed_tpu_torch.ops.cuda.moe_dispatch import inverse_index, permute_rows, resolve_impl

#: the Jitter noise's half-width (JAX ``multiplicative_jitter`` epsilon)
JITTER_EPS = 1e-2


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float, min_capacity: int,
              drop_tokens: bool = True) -> int:
    """Static per-expert capacity; without token dropping the worst case
    (one expert receives every token)."""
    if not drop_tokens:
        return num_tokens
    capacity = math.ceil((num_tokens / num_experts) * capacity_factor)
    # a buffer larger than the token count is pure padding
    return min(max(capacity, min_capacity), num_tokens)


def _gate_capacity(num_tokens: int, num_experts: int, capacity_factor: float,
                   min_capacity: int, drop_tokens: bool, k: int) -> int:
    """The one capacity derivation of the gating cores and
    ``TopKGate.capacity``; top-2 shares one buffer between both choices,
    hence the doubled factor."""
    cf = 2 * capacity_factor if k == 2 else capacity_factor
    return _capacity(num_tokens, num_experts, cf, min_capacity, drop_tokens)


def sec_signature(num_tokens: int, num_experts: int, capacity_factor: float,
                  min_capacity: int, k: int = 1,
                  drop_tokens: bool = True) -> Tuple[int, int, int]:
    """The dense route's ``[S, E, C]`` trailing shape for one group of
    ``num_tokens`` tokens (the tensor the sorted route never builds)."""
    return (num_tokens, num_experts,
            _gate_capacity(num_tokens, num_experts, capacity_factor, min_capacity,
                           drop_tokens, k))


def multiplicative_jitter(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``x`` times its Jitter factors, drawn U(1 - eps, 1 + eps) by
    :meth:`TopKGate.draw_noise` (JAX ``multiplicative_jitter``)."""
    return x * noise


def gumbel_rsample(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with u uniform on [tiny, 1)
    (JAX ``jax.random.gumbel``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _token_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Cumulative sum of an [S, E] mask over its token axis, scanned along
    the inner axis of the transposed copy: PyTorch's CUDA scan over an outer
    axis only E wide ran 1.4 ms per call at S = 8192 on the H100, this one
    a few microseconds."""
    return torch.cumsum(mask.t().contiguous(), dim=1).t()


def _keep_top_capacity(mask: torch.Tensor, priority: torch.Tensor, capacity: int) -> torch.Tensor:
    """Keep at most ``capacity`` selected tokens per expert, highest
    ``priority`` first and, among equal priorities, the lowest token index
    (``jax.lax.top_k``'s order; a stable descending sort gives it).
    ``mask`` [S, E] one-hot, ``priority`` [S, E]."""
    order = torch.sort(priority.t(), dim=1, descending=True, stable=True).indices[:, :capacity]
    sel = torch.zeros_like(mask)
    sel.scatter_(0, order.t(), 1)
    return mask * sel


class SortedRouting(NamedTuple):
    """Per-token-copy routing decisions ([S, k] each, or [G, S, k] from the
    gate): the sorted route's whole interface."""

    expert: torch.Tensor  # int32: the assigned expert
    slot: torch.Tensor    # int32: position inside the expert's capacity buffer
    weight: torch.Tensor  # fp32: combine weight (0 when dropped)
    keep: torch.Tensor    # int32: 1 iff the copy survived capacity


class GateNoise(NamedTuple):
    """The random draws of one training-mode gate call, [G, ...] each; None
    where the configuration takes none."""

    jitter: Optional[torch.Tensor] = None  # [G, S, M] U(1 - eps, 1 + eps) (Jitter)
    gumbel: Optional[torch.Tensor] = None  # [G, S, E] Gumbel (RSample, top-2)
    rts: Optional[torch.Tensor] = None     # [G, S, E] U(0, 1) (random token selection)


def _top1_decisions(logits, capacity_factor, min_capacity, used_token, noisy_gate_policy,
                    drop_tokens, use_rts, gumbel=None, rts=None):
    """The top-1 decision core of both routes: everything up to the
    ``[S,E,C]`` tensors. ``gumbel`` and ``rts`` ([S, E]) are the draws the
    JAX core takes from its rng (None in deterministic calls)."""
    logits = logits.float()
    num_tokens, num_experts = logits.shape
    gates = torch.softmax(logits, dim=1)
    capacity = _gate_capacity(num_tokens, num_experts, capacity_factor, min_capacity,
                              drop_tokens, k=1)
    if noisy_gate_policy == "RSample" and gumbel is not None:
        indices1_s = torch.argmax(logits + gumbel, dim=1)
    else:
        indices1_s = torch.argmax(gates, dim=1)
    mask1 = F.one_hot(indices1_s, num_experts)
    if used_token is not None:
        mask1 = mask1 * used_token[:, None].to(mask1.dtype)
    exp_counts = mask1.sum(dim=0)

    # load-balancing loss over every routed token, before capacity
    me = gates.mean(dim=0)
    ce = mask1.float().mean(dim=0)
    l_aux = (me * ce).sum() * num_experts

    # random token selection: uniform priority makes over-capacity drops
    # unbiased; without it the priority is position order
    if use_rts and rts is not None:
        priority = mask1 * rts
    else:
        priority = mask1.float()
    mask1 = _keep_top_capacity(mask1, priority, capacity)

    # position of each surviving token inside its expert's buffer
    locations1 = _token_cumsum(mask1) - 1
    locations1_s = (locations1 * mask1).sum(dim=1)
    gates_masked = gates * mask1.float()
    return l_aux, gates_masked, mask1, indices1_s, locations1_s, exp_counts, capacity


def top1gating(logits, capacity_factor: float, min_capacity: int,
               used_token: Optional[torch.Tensor] = None, noisy_gate_policy: Optional[str] = None,
               drop_tokens: bool = True, use_rts: bool = True,
               gumbel: Optional[torch.Tensor] = None, rts: Optional[torch.Tensor] = None):
    """Top-1 gating, dense form: ``(l_aux, combine_weights [S,E,C],
    dispatch_mask [S,E,C] bool, exp_counts [E] int32)``."""
    l_aux, gates_masked, _, _, locations1_s, exp_counts, capacity = _top1_decisions(
        logits, capacity_factor, min_capacity, used_token, noisy_gate_policy, drop_tokens,
        use_rts, gumbel, rts)
    locations1_sc = F.one_hot(locations1_s, capacity).to(gates_masked.dtype)
    combine_weights = torch.einsum("se,sc->sec", gates_masked, locations1_sc)
    return l_aux, combine_weights, combine_weights > 0, exp_counts.int()


def top1routing(logits, capacity_factor: float, min_capacity: int,
                used_token: Optional[torch.Tensor] = None, noisy_gate_policy: Optional[str] = None,
                drop_tokens: bool = True, use_rts: bool = True,
                gumbel: Optional[torch.Tensor] = None, rts: Optional[torch.Tensor] = None):
    """Top-1 gating, compact form for the sorted route (the decisions of
    :func:`top1gating`): ``(l_aux, SortedRouting [S,1], exp_counts [E])``."""
    l_aux, gates_masked, mask1, indices1_s, locations1_s, exp_counts, _ = _top1_decisions(
        logits, capacity_factor, min_capacity, used_token, noisy_gate_policy, drop_tokens,
        use_rts, gumbel, rts)
    routing = SortedRouting(expert=indices1_s.int()[:, None],
                            slot=locations1_s.int()[:, None],
                            weight=gates_masked.sum(dim=1)[:, None],  # gate prob, 0 when dropped
                            keep=mask1.sum(dim=1).int()[:, None])
    return l_aux, routing, exp_counts.int()


def _top2_decisions(logits, capacity_factor, min_capacity, drop_tokens, gumbel=None):
    """The top-2 decision core of both routes; ``gumbel`` [S, E] samples
    the second choice (None in deterministic calls)."""
    logits = logits.float()
    num_tokens, num_experts = logits.shape
    gates = torch.softmax(logits, dim=1)
    capacity = _gate_capacity(num_tokens, num_experts, capacity_factor, min_capacity,
                              drop_tokens, k=2)
    indices1_s = torch.argmax(gates, dim=1)
    mask1 = F.one_hot(indices1_s, num_experts)

    # the second expert by Gumbel-max over the remaining logits
    logits_w_noise = logits + gumbel if gumbel is not None else logits
    logits_except1 = logits_w_noise.masked_fill(mask1.bool(), float("-inf"))
    indices2_s = torch.argmax(logits_except1, dim=1)
    mask2 = F.one_hot(indices2_s, num_experts)

    locations1 = _token_cumsum(mask1) - 1
    locations2 = _token_cumsum(mask2) - 1
    # second-choice tokens queue behind every first-choice token
    locations2 = locations2 + mask1.sum(dim=0, keepdim=True)

    exp_counts = mask1.sum(dim=0)
    me = gates.mean(dim=0)
    ce = mask1.float().mean(dim=0)
    l_aux = (me * ce).mean() * num_experts * num_experts

    mask1 = mask1 * (locations1 < capacity)
    mask2 = mask2 * (locations2 < capacity)
    locations1_s = (locations1 * mask1).sum(dim=1)
    locations2_s = (locations2 * mask2).sum(dim=1)

    mask1_f, mask2_f = mask1.float(), mask2.float()
    gates1_s = (gates * mask1_f).sum(dim=1)
    gates2_s = (gates * mask2_f).sum(dim=1)
    denom_s = torch.clamp(gates1_s + gates2_s, min=torch.finfo(torch.float32).eps)
    gates1_s = gates1_s / denom_s
    gates2_s = gates2_s / denom_s
    return (l_aux, (mask1, mask2), (mask1_f, mask2_f), (indices1_s, indices2_s),
            (locations1_s, locations2_s), (gates1_s, gates2_s), exp_counts, capacity)


def top2gating(logits, capacity_factor: float, min_capacity: int, drop_tokens: bool = True,
               gumbel: Optional[torch.Tensor] = None):
    """Top-2 gating, dense form: ``(l_aux, combine_weights [S,E,C],
    dispatch_mask [S,E,C] bool, exp_counts [E] int32)``."""
    (l_aux, _, (mask1_f, mask2_f), _, (locations1_s, locations2_s),
     (gates1_s, gates2_s), exp_counts, capacity) = _top2_decisions(
        logits, capacity_factor, min_capacity, drop_tokens, gumbel)
    gates1 = gates1_s[:, None] * mask1_f
    gates2 = gates2_s[:, None] * mask2_f
    locations1_sc = F.one_hot(locations1_s, capacity).to(gates1.dtype)
    locations2_sc = F.one_hot(locations2_s, capacity).to(gates2.dtype)
    combine_weights = (torch.einsum("se,sc->sec", gates1, locations1_sc)
                       + torch.einsum("se,sc->sec", gates2, locations2_sc))
    return l_aux, combine_weights, combine_weights > 0, exp_counts.int()


def top2routing(logits, capacity_factor: float, min_capacity: int, drop_tokens: bool = True,
                gumbel: Optional[torch.Tensor] = None):
    """Top-2 gating, compact form: ``(l_aux, SortedRouting [S,2],
    exp_counts [E])``; copy 0 is the argmax expert, copy 1 the sampled
    second choice."""
    (l_aux, (mask1, mask2), _, (indices1_s, indices2_s), (locations1_s, locations2_s),
     (gates1_s, gates2_s), exp_counts, _) = _top2_decisions(
        logits, capacity_factor, min_capacity, drop_tokens, gumbel)
    keep1 = mask1.sum(dim=1)
    keep2 = mask2.sum(dim=1)
    stack = lambda a, b: torch.stack([a, b], dim=1)
    routing = SortedRouting(
        expert=stack(indices1_s, indices2_s).int(),
        slot=stack(locations1_s, locations2_s).int(),
        # the normalized weights carry no mask: zero the dropped copies
        weight=stack(gates1_s * keep1, gates2_s * keep2),
        keep=stack(keep1, keep2).int())
    return l_aux, routing, exp_counts.int()


class TopKGate(nn.Module):
    """The gate: a bias-free fp32 linear ``wg`` [M, E] and top-k gating over
    ``[groups, tokens, model]``. ``route="dense"`` returns ``(l_aux,
    combine_weights [G,S,E,C], dispatch_mask, exp_counts)``, ``"sorted"``
    returns ``(l_aux, SortedRouting [G,S,k], exp_counts)``.

    ``dtype`` is the model's compute dtype: ``wg`` is rounded to it and then
    used in fp32, as the JAX engine casts every parameter before ``apply``
    and the gate promotes back to fp32. Logits and softmax are fp32."""

    def __init__(self, model_dim: int, num_experts: int, k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 8,
                 noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
                 use_rts: bool = True, route: str = "dense", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if k not in (1, 2):
            raise ValueError(f"Only top-1 and top-2 gatings are supported (got k={k})")
        self.model_dim, self.num_experts, self.k = model_dim, num_experts, k
        self.capacity_factor, self.eval_capacity_factor = capacity_factor, eval_capacity_factor
        self.min_capacity, self.noisy_gate_policy = min_capacity, noisy_gate_policy
        self.drop_tokens, self.use_rts, self.route, self.dtype = drop_tokens, use_rts, route, dtype
        self.wg = nn.Parameter(torch.zeros((model_dim, num_experts), dtype=torch.float32,
                                           device=device))

    def needs_noise(self, deterministic: bool) -> bool:
        """Whether a call draws noise (the JAX gate's ``make_rng`` condition:
        training with RTS, a noisy gate policy, or top-2)."""
        return not deterministic and (self.use_rts or self.noisy_gate_policy is not None
                                      or self.k == 2)

    def draw_noise(self, generator: torch.Generator, tokens: torch.Tensor) -> GateNoise:
        """This call's draws for ``tokens`` [G, S, M], from ``generator``:
        the Jitter factors, then the Gumbel noise, then the RTS uniforms,
        each only where the configuration takes it."""
        groups, num_tokens, model_dim = tokens.shape
        dev = tokens.device
        scores = (groups, num_tokens, self.num_experts)
        jitter = gumbel = rts = None
        if self.noisy_gate_policy == "Jitter":
            u = torch.rand((groups, num_tokens, model_dim), generator=generator, device=dev)
            jitter = u * (2 * JITTER_EPS) + (1.0 - JITTER_EPS)
        if self.k == 2 or self.noisy_gate_policy == "RSample":
            gumbel = gumbel_rsample(generator, scores, dev)
        if self.k == 1 and self.use_rts:
            rts = torch.rand(scores, generator=generator, device=dev)
        return GateNoise(jitter, gumbel, rts)

    def forward(self, tokens: torch.Tensor, used_token: Optional[torch.Tensor] = None,
                deterministic: bool = True, noise: Optional[GateNoise] = None,
                route: Optional[str] = None):
        route = self.route if route is None else route
        if deterministic:
            noise = None  # eval gating: eval capacity factor, no RTS or noise
        noise = noise if noise is not None else GateNoise()
        x = tokens.float()
        if noise.jitter is not None:
            x = multiplicative_jitter(x, noise.jitter)
        logits = x @ self.wg.to(self.dtype).float()  # [G, S, E]
        cf = self._cf(deterministic)
        groups = logits.shape[0]
        ut = None if used_token is None else used_token.reshape(groups, -1)
        part = lambda t, g: None if t is None else t[g]
        outs = []
        for g in range(groups):
            if self.k == 1:
                fn = top1routing if route == "sorted" else top1gating
                outs.append(fn(logits[g], cf, self.min_capacity, part(ut, g),
                               None if deterministic else self.noisy_gate_policy,
                               self.drop_tokens, self.use_rts, gumbel=part(noise.gumbel, g),
                               rts=part(noise.rts, g)))
            else:
                fn = top2routing if route == "sorted" else top2gating
                outs.append(fn(logits[g], cf, self.min_capacity, self.drop_tokens,
                               gumbel=part(noise.gumbel, g)))
        l_aux = torch.stack([o[0] for o in outs]).mean()
        exp_counts = torch.stack([o[-1] for o in outs]).sum(dim=0)
        if route == "sorted":
            routing = SortedRouting(*(torch.stack([o[1][i] for o in outs]) for i in range(4)))
            return l_aux, routing, exp_counts
        return (l_aux, torch.stack([o[1] for o in outs]), torch.stack([o[2] for o in outs]),
                exp_counts)

    def _cf(self, deterministic: bool) -> float:
        return self.capacity_factor if not deterministic else self.eval_capacity_factor

    def capacity(self, num_tokens: int, deterministic: bool = True) -> int:
        """The per-expert capacity for a group of ``num_tokens``, the one the
        cores assign slots against (the sorted route sizes its buffer with
        it)."""
        return _gate_capacity(num_tokens, self.num_experts, self._cf(deterministic),
                              self.min_capacity, self.drop_tokens, self.k)


class Experts(nn.Module):
    """The experts, with their parameters stacked along a leading expert axis
    (``[E, M, 4M]`` and so on, the layout of the JAX ``nn.vmap``), run as one
    batched product per projection over the ``[E, G*C, M]`` buffer.

    ``expert`` gives the layout: it must offer ``stacked(num_experts)``,
    a module of ``num_experts`` stacked copies that maps ``[E, T, M]`` to
    ``[E, T, M]`` (the GPT-2 ``MLP`` does). Each stacked parameter carries
    ``allreduce = False``, the reference's expert-parameter tag."""

    def __init__(self, expert: nn.Module, num_experts: int):
        super().__init__()
        stacked = getattr(expert, "stacked", None)
        if not callable(stacked):
            raise TypeError(f"{type(expert).__name__} cannot run as stacked experts: it needs a "
                            f"stacked(num_experts) method returning a module over [E, T, M]")
        self.num_experts = num_experts
        self.deepspeed_experts = stacked(num_experts)
        for p in self.deepspeed_experts.parameters():
            p.allreduce = False

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x`` [G, E, C, M] -> [G, E, C, M]; ``generator`` drives the
        experts' dropout."""
        g, e, c, m = x.shape
        out = self.deepspeed_experts(x.transpose(0, 1).reshape(e, g * c, m), generator)
        return out.reshape(e, g, c, out.shape[-1]).transpose(0, 1)


class MOELayer(nn.Module):
    """The MoE layer: gate, dispatch, experts, combine. ``route`` and
    ``route_kernel`` pin the route and the permutation; None resolves
    through ``DS_MOE_ROUTE``/``DS_MOE_KERNEL``, the engine's ``"moe"``
    block, then ``"sorted"``/``"auto"`` (``moe/routing.py``).

    After each call the layer holds its load statistics: ``exp_counts``
    (first choices before capacity), ``kept_counts`` (token copies after
    capacity), ``routed_counts`` (all k copies before capacity; None on the
    dense top-2 route, whose gate hides the second choices),
    ``capacity_slots`` (buffer slots per expert over all groups) and, on the
    sorted route, ``last_routing`` (the :class:`SortedRouting`). The gate
    lives on ``device``, by default the expert's."""

    def __init__(self, expert: nn.Module, model_dim: int, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 8, noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True, route: Optional[str] = None,
                 route_kernel: Optional[str] = None, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.model_dim, self.num_experts, self.k = model_dim, num_experts, k
        self.route, self.route_kernel = route, route_kernel
        if device is None:
            device = next(expert.parameters()).device
        self.gate = TopKGate(model_dim, num_experts, k, capacity_factor, eval_capacity_factor,
                             min_capacity, noisy_gate_policy, drop_tokens, use_rts, dtype=dtype,
                             device=device)
        self.experts = Experts(expert, num_experts)
        self.exp_counts = self.kept_counts = self.routed_counts = None
        self.capacity_slots = None
        self.last_routing: Optional[SortedRouting] = None

    def forward(self, hidden_states: torch.Tensor, used_token: Optional[torch.Tensor] = None,
                deterministic: bool = True, *, gate_generator: Optional[torch.Generator] = None,
                gate_noise: Optional[GateNoise] = None,
                generator: Optional[torch.Generator] = None):
        """``(output, l_aux fp32, exp_counts)``. A training call
        (``deterministic=False``) whose gate draws noise takes the draws as
        ``gate_noise`` or draws them from ``gate_generator``; ``generator``
        drives the experts' dropout."""
        orig_shape, orig_dtype = hidden_states.shape, hidden_states.dtype
        route, kernel, _ = resolve_route(self.route, self.route_kernel)
        groups = 1  # one device, no mesh
        tokens = hidden_states.reshape(groups, -1, orig_shape[-1])
        noise = None
        if self.gate.needs_noise(deterministic):
            noise = gate_noise
            if noise is None:
                if gate_generator is None:
                    raise ValueError("training-mode gating (RTS, a noisy gate or top-2) draws "
                                     "noise: pass gate_generator= or gate_noise=")
                noise = self.gate.draw_noise(gate_generator, tokens)
        if route == "sorted":
            out, l_aux, exp_counts, kept, routed, capacity = self._sorted_route(
                tokens, used_token, deterministic, noise, kernel, orig_dtype, generator)
        else:
            out, l_aux, exp_counts, kept, routed, capacity = self._dense_route(
                tokens, used_token, deterministic, noise, orig_dtype, generator)
        self.exp_counts, self.kept_counts, self.routed_counts = exp_counts, kept, routed
        self.capacity_slots = groups * capacity
        return out.reshape(orig_shape), l_aux.float(), exp_counts

    def _dense_route(self, tokens, used_token, deterministic, noise, orig_dtype, generator):
        with record_function("moe_gate"):
            l_aux, combine_weights, dispatch_mask, exp_counts = self.gate(
                tokens, used_token, deterministic, noise, route="dense")
        # dispatch: [G,S,E,C] x [G,S,M] -> [G,E,C,M]; combine the reverse
        with record_function("moe_dispatch"):
            dispatched = torch.einsum("gsec,gsm->gecm", dispatch_mask.to(orig_dtype), tokens)
        with record_function("moe_experts"):
            expert_out = self.experts(dispatched, generator)
        with record_function("moe_combine"):
            combined = torch.einsum("gsec,gecm->gsm", combine_weights.to(orig_dtype), expert_out)
        kept_counts = dispatch_mask.sum(dim=(0, 1, 3)).int()
        # k=1: every routed copy is a first choice; k=2: the dense gate's
        # return hides the second choices, so no exact denominator
        routed_counts = exp_counts if self.k == 1 else None
        self.last_routing = None
        return combined, l_aux, exp_counts, kept_counts, routed_counts, combine_weights.shape[-1]

    def _sorted_route(self, tokens, used_token, deterministic, noise, kernel, orig_dtype,
                      generator):
        groups, num_tokens, d_model = tokens.shape
        capacity = self.gate.capacity(num_tokens, deterministic)
        E, C, k = self.num_experts, capacity, self.k
        impl = resolve_impl(kernel)
        with record_function("moe_gate"):
            l_aux, routing, exp_counts = self.gate(tokens, used_token, deterministic, noise,
                                                   route="sorted")
            # each kept copy owns the unique slot expert*C + position;
            # dropped copies park on the E*C sentinel (zero rows, no reads)
            flat_slot = torch.where(routing.keep > 0, routing.expert * C + routing.slot,
                                    E * C).to(torch.int32).reshape(groups, num_tokens * k)
            src = inverse_index(flat_slot, E * C)  # [G, E*C]: slot -> token copy

        with record_function("moe_dispatch"):
            # copy j of token s at row s*k + j (the [S, k] fields' order)
            tok_rep = tokens.repeat_interleave(k, dim=1) if k > 1 else tokens
            dispatched = permute_rows(tok_rep, src, flat_slot, impl=impl)
        with record_function("moe_experts"):
            expert_out = self.experts(dispatched.reshape(groups, E, C, d_model), generator)

        with record_function("moe_combine"):
            # gather each copy's expert output back and weight it
            gathered = permute_rows(expert_out.reshape(groups, E * C, d_model), flat_slot, src,
                                    impl=impl)
            weights = routing.weight.to(orig_dtype).reshape(groups, num_tokens * k, 1)
            combined = (weights * gathered).reshape(groups, num_tokens, k, d_model).sum(dim=2)

        flat_expert = routing.expert.reshape(-1).long()
        kept_counts = torch.zeros(E, dtype=torch.int32, device=tokens.device).index_add_(
            0, flat_expert, routing.keep.reshape(-1))
        routed_counts = exp_counts if k == 1 else exp_counts + torch.zeros_like(
            kept_counts).index_add_(0, routing.expert[..., 1].reshape(-1).long(),
                                    torch.ones_like(routing.keep[..., 1].reshape(-1)))
        self.last_routing = SortedRouting(*(t.detach() for t in routing))
        return combined, l_aux, exp_counts, kept_counts, routed_counts, capacity
