"""Continuous in-flight batching over the per-slot decode cache
(counterpart of ``deepspeed_tpu/inference/serving/scheduler.py``).

One scheduler drives one :class:`InferenceEngine` through three
fixed-shape steps (``serving/programs.py``): requests join and leave decode
slots on every tick, chunked prefill interleaves long prompts with
in-flight decodes, and speculative decoding drafts with a layer-reduced
student of the target and verifies the block in one target pass.
Admission is block-pool truthful (``queue.py``): a request is admitted
only when its worst-case KV footprint is reservable, so nothing dies
mid-flight and nothing leaks. A byte budget (``kv_pool_bytes``) is turned
into tokens from the cache's own per-token footprint.

Host protocol: the scheduler's numpy ``lengths`` mirror is authoritative.
Every tick stamps it into the cache's index leaves; a parked slot carries
the sentinel position (= slot capacity) so its writes drop, and a rejected
draft never advances the mirror past the accepted prefix.

With the prefix cache on (the default), a prompt's committed full blocks
are published (their KV rows copied to the host) when its prefill
completes and when it retires; a later prompt with the same prefix has
those rows restored into its slot and prefills only its tail.

With ``weight_dtype`` int8/int4 every projection runs kernel K2 over
per-group codes (the drafter's too, in int8); every tick's attention runs
kernel K3 when the engine was built with the flash backend. ``serve``
drains on SIGTERM/SIGINT and returns 143. A ``RuntimeTelemetry`` bus, when
given, receives the tick spans and the ``serve_tick``, ``serve_request``
and ``serve_drain`` events (``events.py``). ``swap_served_params``
hot-swaps the served weights between ticks (the RLHF weight sync,
``runtime/rlhf``): a copy into the served module's tensors in place,
re-encoded under ``weight_dtype`` int8/int4, and digest-verified when
asked; it emits ``rlhf_weight_sync``. Live migration (the fleet,
``inference/fleet``): ``export_inflight`` copies every in-flight request's
bookkeeping and committed KV rows to the host, ``release_inflight`` frees
their slots, and a peer's ``admit_migrated`` restores them into a free slot,
so a greedy continuation is bit-exact; ``serve(migrate=)`` tries that hook on
a signal before the drain.
"""

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.device import host_to_device
from deepspeed_tpu_torch.elasticity.elastic_agent import HEARTBEAT_ENV, touch_heartbeat
from deepspeed_tpu_torch.inference.engine import replace_transformer_layer
from deepspeed_tpu_torch.inference.serving.blocks import BlockPool, PrefixMatch
from deepspeed_tpu_torch.inference.serving.config import ServingConfig
from deepspeed_tpu_torch.inference.serving.programs import (KV_LEAVES, _leaf_name,
                                                            make_slot_cache, serve_programs,
                                                            slot_capacity, stamp_lengths)
from deepspeed_tpu_torch.inference.serving.queue import RequestQueue
from deepspeed_tpu_torch.inference.serving.request import ACTIVE, FINISHED, PREFILL, Request
from deepspeed_tpu_torch.models.common import flatten_tree, nest_tree
from deepspeed_tpu_torch.ops.quantizer.weights import quantize_params
from deepspeed_tpu_torch.runtime.resilience.signals import (DEFAULT_PREEMPT_EXIT_CODE,
                                                            PreemptionGuard)
from deepspeed_tpu_torch.runtime.telemetry.metrics import Histogram
from deepspeed_tpu_torch.runtime.telemetry.spans import NULL_SPAN

logger = logging.getLogger(__name__)


class MigrationError(RuntimeError):
    """Live KV migration refused or failed verification. Raised instead of
    degrading: a half-migrated request is worse than a drained one, so the
    callers (``serve``'s migrate hook, the fleet router) fall back to the
    drain when they see it."""


#: request states a migration payload describes: a PREFILL request by its
#: prompt, ``prefill_pos`` and committed KV; an ACTIVE one adds its output
#: and next token. A queued request has no KV: the router re-dispatches it.
MIGRATABLE_STATES = (PREFILL, ACTIVE)


def _quant_state(state: Dict[str, torch.Tensor], weight_dtype: str,
                 group_size: int) -> Dict[str, torch.Tensor]:
    """The quantized serving state dict of fp ``state``: per-group codes
    and their ``kernel_scale`` leaves (``ops/quantizer/weights.quantize_params``)."""
    qparams, qscales = quantize_params(nest_tree(state, "."), weight_dtype, group_size)
    out = flatten_tree(qparams, ".")
    out.update(flatten_tree(qscales, "."))
    return out


def _quant_view(module, weight_dtype: str, group_size: int):
    """The weight-quantized serving module: the same architecture rebuilt
    with ``serve_weight_dtype`` set, holding per-group codes and scales of
    ``module``'s weights. ``module`` keeps its fp weights."""
    cfg = getattr(module, "config", None)
    if cfg is None or not any(f.name == "serve_weight_dtype" for f in dataclasses.fields(cfg)):
        raise NotImplementedError(f"{type(module).__name__} does not declare the "
                                  f"serve_weight_dtype seam for weight-quantized serving")
    q_cfg = dataclasses.replace(cfg, serve_weight_dtype=weight_dtype,
                                serve_weight_group_size=group_size)
    q_module = type(module)(q_cfg, device=module.device)
    q_module.load_state_dict(_quant_state(module.state_dict(), weight_dtype, group_size),
                             strict=True)
    return q_module


def _kv_leaf_names(cache: Dict[str, torch.Tensor]) -> List[str]:
    """The cache's KV pool leaves and their int8 scale companions."""
    return [name for name in cache
            if _leaf_name(name) in KV_LEAVES or name.endswith("_scale")]


class ContinuousBatchingScheduler:
    """Continuous (in-flight) batching over one engine.

    ``drafter``: the speculation drafter, a model (or ``(model, state
    dict)``) of the target's family, typically the layer-reduced student
    from ``compression.student_initialization``; required when
    ``config.speculation.enabled``. It is rebuilt as the engine rebuilt the
    target (dtype, attention backend, device), and served int8 whenever the
    target serves quantized weights.

    ``clock``: injectable time source (``time.monotonic`` by default); tests
    drive a simulated clock. ``telemetry``: an optional ``RuntimeTelemetry``.
    ``seed`` seeds the sampling generator."""

    def __init__(self, engine, config=None, drafter=None,
                 clock: Optional[Callable[[], float]] = None, telemetry=None, seed: int = 0):
        if config is None:
            config = ServingConfig()
        elif isinstance(config, dict):
            config = ServingConfig(**config)
        mcfg = engine.module.config
        if not any(f.name == "serve_weight_dtype" for f in dataclasses.fields(mcfg)):
            # as the JAX scheduler refuses it (its _quant_view and
            # _probe_slot_decode): the LLaMA family decodes against the
            # lockstep cache only
            raise NotImplementedError(
                f"{type(engine.module).__name__} does not support the per-slot (ragged) decode "
                f"cache and the serve_weight_dtype seam the scheduler serves with; serve it with "
                f"init_inference(...).generate")
        if getattr(engine, "_wq_scales", None) is not None:
            # JAX serves such an engine through its in-graph dequantize; the
            # port's scheduler serves its own int8 view (weight_dtype)
            raise NotImplementedError(
                "the scheduler serves an engine with fp weights; an engine built with "
                "dtype='int8' or quant.enabled holds the weight_quantizer format, which the "
                "serving steps do not take: build the engine without it and serve "
                "ServingConfig(weight_dtype='int8') (kernel K2)")
        self.config = config
        self.engine = engine
        self.device = engine.device
        self.clock = clock or time.monotonic
        self.telemetry = telemetry
        self.weight_dtype = config.resolved_weight_dtype
        self.kv_quant = bool(config.kv_quant)
        self.module = engine.module
        if self.weight_dtype != "fp":
            self.module = _quant_view(engine.module, self.weight_dtype, config.weight_group_size)

        # pow2 slot bucket, as the JAX scheduler
        self.slots = engine._pow2_bucket(config.slots)
        self._cache = make_slot_cache(self.module, self.slots, kv_quant=self.kv_quant)
        self.capacity = slot_capacity(self._cache)  # tokens per slot

        # admission: a byte budget is sized into tokens from the cache's
        # own per-token footprint (int8 codes + scales under kv_quant)
        pool_tokens = config.kv_pool_tokens or self.slots * self.capacity
        if config.kv_pool_bytes:
            pool_tokens = max(config.page_size,
                              int(config.kv_pool_bytes / max(1.0, self._kv_bytes_per_token())))
        # the hash envelope folds in every knob that makes cached KV bytes
        # non-reusable: int8 KV, the served weight dtype, and speculation
        # (whose payload also carries the drafter's rows)
        self.prefix_cache = config.resolved_prefix_cache
        self.spec_k = int(config.speculation.k) if config.speculation.enabled else 0
        envelope = f"kvq:{int(self.kv_quant)}/wq:{self.weight_dtype}/spec:{self.spec_k}"
        self._envelope = envelope
        # requests whose KV rows span a weight swap: never published again
        self._no_publish: set = set()
        self.pool = BlockPool(num_blocks=max(1, pool_tokens // config.page_size),
                              block_size=config.page_size,
                              prefix_cache=self.prefix_cache == "on", envelope=envelope)
        self.queue = RequestQueue(self.pool, max_queue=config.max_queue,
                                  max_total_tokens=self.capacity, clock=self.clock)

        self.kv_write = config.resolved_kv_write  # reported; both values scatter (programs.py)
        if self.spec_k and drafter is None:
            raise ValueError("speculation.enabled needs a drafter: pass drafter=model, e.g. the "
                             "layer-reduced student from compression.student_initialization")
        sampling = dict(do_sample=config.do_sample, temperature=config.temperature,
                        top_k=config.top_k, top_p=config.top_p)
        self.fns = serve_programs(self.module, spec_k=self.spec_k, **sampling)
        self._drafter = None
        if drafter is not None and self.spec_k:
            d_model, d_state = drafter if isinstance(drafter, tuple) else (drafter, None)
            d_module = replace_transformer_layer(d_model, engine.config, self.device, d_state)
            if self.weight_dtype != "fp":
                # the drafter rides int8 whenever the target serves quantized
                d_module = _quant_view(d_module, "int8", config.weight_group_size)
            self._drafter = d_module
            self._drafter_cache = make_slot_cache(d_module, self.slots, kv_quant=self.kv_quant)
            if slot_capacity(self._drafter_cache) < self.capacity:
                raise ValueError("drafter context capacity is smaller than the target's; it "
                                 "cannot draft to the end of a maximal request")
            self.dfns = serve_programs(d_module, spec_k=self.spec_k, **sampling)

        # host-side authoritative slot state
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        self._lengths = np.full(self.slots, self.capacity, np.int64)  # parked sentinel
        self._next_token = np.zeros(self.slots, np.int64)
        self._decode_ticks_since_prefill = 10**9  # the first prefill never waits
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

        # evidence: latency histograms, tick and speculation counters
        self.ttft_hist = Histogram()
        self.tok_hist = Histogram()
        self.ticks = {"prefill": 0, "decode": 0, "spec": 0, "idle": 0}
        # achieved-throughput clock zero: the first non-idle tick
        self._serve_t0: Optional[float] = None
        self.drafted_total = 0
        self.accepted_total = 0
        self.finished: List[Request] = []
        # rollout counters of the serve_tick schema (an RLHF loop,
        # runtime/rlhf, moves them)
        self.rollout_experience = 0
        self.learner_steps_overlapped = 0
        self.weight_sync_generation = 0
        self.last_weight_sync: Optional[dict] = None

    def _kv_bytes_per_token(self) -> float:
        """KV bytes per cached token, off the slot cache's pool and scale
        leaves: int8 KV holds one code byte per element plus the
        per-(slot, position, head) scale."""
        total = sum(self._cache[name].numel() * self._cache[name].element_size()
                    for name in _kv_leaf_names(self._cache))
        return total / float(self.slots * self.capacity)

    def _span(self, name: str):
        return self.telemetry.span(name) if self.telemetry is not None else NULL_SPAN

    def _sampling_args(self):
        return (self._generator,) if self.config.do_sample else ()

    def _roles(self):
        """(role, cache) of every cache a slot's KV lives in."""
        roles = [("target", self._cache)]
        if self._drafter is not None:
            roles.append(("drafter", self._drafter_cache))
        return roles

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Run every step this scheduler can run once against fully parked
        caches (every KV write drops, outputs are discarded), so the kernels
        are built and loaded before the first request is timed. A
        speculating scheduler never runs the target's plain decode, so that
        one is skipped. Touches no request accounting."""
        parked = np.full(self.slots, self.capacity, np.int64)
        chunk = self.config.prefill_chunk
        ids = torch.zeros((self.slots, chunk), dtype=torch.int64, device=self.device)
        last_idx = torch.zeros((self.slots,), dtype=torch.int64, device=self.device)
        tok = torch.zeros((self.slots,), dtype=torch.int64, device=self.device)
        block = torch.zeros((self.slots, self.spec_k + 1), dtype=torch.int64, device=self.device)
        gen = (torch.Generator(device=self.device).manual_seed(0),) if self.config.do_sample else ()
        calls = [(self.fns, self._cache, "prefill", (ids, last_idx) + gen)]
        calls.append((self.fns, self._cache, "verify", (block,)) if self.spec_k
                     else (self.fns, self._cache, "decode", (tok,) + gen))
        if self._drafter is not None:
            calls += [(self.dfns, self._drafter_cache, "prefill", (ids, last_idx)),
                      (self.dfns, self._drafter_cache, "decode", (tok,)),
                      (self.dfns, self._drafter_cache, "verify", (block,))]
        for fns, cache, name, args in calls:
            fns[name](stamp_lengths(cache, parked), *args)

    # ------------------------------------------------------------------
    # submission / admission
    # ------------------------------------------------------------------
    def submit(self, request: Request) -> Request:
        return self.queue.submit(request)

    @property
    def in_flight(self) -> List[Request]:
        return [r for r in self._slot_req if r is not None]

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _admit(self) -> int:
        free = self._free_slots()
        admitted = self.queue.admit(len(free))
        for slot, req in zip(free, admitted):
            self._slot_req[slot] = req
            # the reservation may have matched an indexed prefix: restore its
            # rows and prefill only the tail (the match leaves >= 1 prompt
            # token, whose logits give the first new token)
            cached = 0
            match = self.pool.take_match(req.request_id)
            if match is not None and match.cached_tokens:
                self._restore_prefix(slot, match)
                cached = match.cached_tokens
            self._lengths[slot] = cached
            req.state = PREFILL
            req.prefill_pos = cached
            req.cached_prefix_tokens = cached
        return len(admitted)

    # -- prefix cache --------------------------------------------------
    def _kv_groups(self) -> Dict[tuple, List[tuple]]:
        """Every role's KV leaves grouped by (dtype, row shape), role by
        role: ``{(dtype, row shape): [(role, leaf), ...]}`` (under int8 KV
        the codes and the scales)."""
        groups: Dict[tuple, List[tuple]] = {}
        for role, cache in self._roles():
            for name in _kv_leaf_names(cache):
                leaf = cache[name]
                groups.setdefault((leaf.dtype, tuple(leaf.shape[2:])), []).append((role, name))
        return groups

    def _kv_rows(self, slot: int, start: int, stop: int) -> Dict[tuple, torch.Tensor]:
        """Host copies of rows ``[start:stop)`` of one slot's KV leaves (the
        publish payload): for each group of :meth:`_kv_groups`, its leaves'
        rows sliced on the device and stacked, ``[leaves, rows, ...]``, and
        copied to the host at once: one copy (one sync) a group. The stack
        is a copy on the CPU too: the slot's rows are rewritten by the next
        request it serves."""
        caches = dict(self._roles())
        return {key: torch.stack([caches[role][name][slot, start:stop] for role, name in members]).cpu()
                for key, members in self._kv_groups().items()}

    def _role_spans(self) -> Dict[tuple, Dict[str, tuple]]:
        """For each group of :meth:`_kv_groups`, each role's leaves: their
        range in the group's stack and their names."""
        spans: Dict[tuple, Dict[str, tuple]] = {}
        for key, members in self._kv_groups().items():
            for i, (role, name) in enumerate(members):
                lo, _, names = spans.setdefault(key, {}).get(role, (i, i, ()))
                spans[key][role] = (lo, i + 1, names + (name,))
        return spans

    def _restore_prefix(self, slot: int, match: PrefixMatch) -> None:
        """Write a match's payload rows into ``slot`` of every cache (target,
        and drafter when speculating): the full blocks' rows, then the first
        ``partial_tokens`` rows of the partial block (copy-on-write: the
        shared block's payload is read, never written). Every group is
        checked before any leaf is written, and each group of a role goes to
        the card in one copy."""
        n = match.cached_tokens
        payloads = match.payloads + ([match.partial_payload] if match.partial_tokens else [])
        caches = dict(self._roles())
        writes = []
        for key, roles in self._role_spans().items():
            for role, (_, _, names) in roles.items():
                parts = []
                for j, payload in enumerate(payloads):
                    rows = payload.get(role, {}).get(key) if isinstance(payload, dict) else None
                    if rows is None:
                        raise RuntimeError(f"prefix-cache payload missing {role!r} KV rows of "
                                           f"{key}; the pool indexed a block this scheduler "
                                           f"cannot restore")
                    parts.append(rows[:, :match.partial_tokens] if j == len(match.payloads) else rows)
                rows = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
                want = (len(names), n) + key[1]
                if tuple(rows.shape) != want or rows.dtype != key[0]:
                    raise RuntimeError(f"prefix-cache rows ({role}) are {rows.dtype}"
                                       f"{tuple(rows.shape)}, the slot takes {key[0]}{want}")
                writes.append((caches[role], names, rows))
        self._write_rows(slot, n, writes)

    def _write_rows(self, slot: int, n: int, writes: List[tuple]) -> None:
        """Copy checked host rows into rows ``[:n)`` of ``slot``: each
        ``(cache, names, rows [len(names), n, ...])`` goes to the card in one
        copy."""
        for cache, names, rows in writes:
            rows = host_to_device(rows, self.device)
            for i, name in enumerate(names):
                cache[name][slot, :n].copy_(rows[i])

    def _publish_prefix(self, slot: int, req: Request) -> None:
        """Index ``req``'s committed full blocks: the prompt when its prefill
        completes, prompt + output at retirement (so a follow-up turn
        re-matches its own history). The pool asks for rows only for blocks
        not hashed yet, and the first request copies every new row up to the
        committed length at once, so a shared prefix is copied once. A
        block's payload is ``{role: {group: rows [leaves, block, ...]}}``:
        a few views a block, not one a leaf, so the index adds few objects
        for Python's garbage collector to walk."""
        if self.prefix_cache != "on" or req.request_id in self._no_publish:
            return
        committed = int(self._lengths[slot])
        if committed < self.pool.block_size:
            return
        tokens = np.concatenate([np.asarray(req.prompt, np.int64),
                                 np.asarray(req.output, np.int64)])[:committed]
        fetched: dict = {}
        spans = self._role_spans()

        def fetch(start: int, stop: int) -> dict:
            if not fetched:
                fetched["base"] = start
                fetched["rows"] = self._kv_rows(slot, start, committed)
            a, b = start - fetched["base"], stop - fetched["base"]
            out: dict = {}
            for key, rows in fetched["rows"].items():
                for role, (lo, hi, _) in spans[key].items():
                    out.setdefault(role, {})[key] = rows[lo:hi, a:b]
            return out

        self.pool.publish(req.request_id, tokens, fetch=fetch)

    # ------------------------------------------------------------------
    # tick
    # ------------------------------------------------------------------
    def step(self, admit: bool = True) -> str:
        """One scheduler tick; returns the tick kind it ran
        (``prefill`` | ``decode`` | ``spec`` | ``idle``)."""
        step_no = sum(self.ticks.values()) + 1
        if self.telemetry is not None:
            self.telemetry.begin_step(step_no)
        with self._span("serve_admit"):
            if admit:
                self._admit()
        prefilling = [i for i, r in enumerate(self._slot_req)
                      if r is not None and r.state == PREFILL]
        active = [i for i, r in enumerate(self._slot_req) if r is not None and r.state == ACTIVE]
        if prefilling and (not active or self._decode_ticks_since_prefill
                           >= self.config.prefill_interleave):
            kind = "prefill"
            with self._span("serve_prefill"):
                self._prefill_tick(prefilling)
            self._decode_ticks_since_prefill = 0
        elif active:
            kind = "spec" if self.spec_k else "decode"
            with self._span(f"serve_{kind}"):
                if self.spec_k:
                    self._spec_tick(active)
                else:
                    self._decode_tick(active)
            self._decode_ticks_since_prefill += 1
        else:
            kind = "idle"
        if kind != "idle" and self._serve_t0 is None:
            self._serve_t0 = self.clock()
        self.ticks[kind] += 1
        if self.telemetry is not None:
            self.telemetry.end_step(step_no)
            every = self.config.tick_telemetry_every
            if every and step_no % every == 0:
                # buffered: the window flush writes it out
                self.telemetry.emit("serve_tick", flush=False, tick=step_no, kind=kind,
                                    **self.signals())
        self._touch_serving_heartbeat(step_no)
        return kind

    # ------------------------------------------------------------------
    # load signals
    # ------------------------------------------------------------------
    def signals(self) -> dict:
        """The per-tick load signals: queue depth, in-flight slots, TTFT
        p50/p99, pool occupancy and fragmentation, achieved tokens/s, the
        prefix cache's hit rate and hot prefixes. The ``serve_tick`` event's
        body, and what a fleet router and autoscaler read."""
        ttft = self.ttft_hist
        return {
            "queue_depth": len(self.queue),
            "in_flight": len(self.in_flight),
            "slots": self.slots,
            "free_slots": len(self._free_slots()),
            "finished": len(self.finished),
            "ttft_p50": ttft.percentile(50) if ttft.count else None,
            "ttft_p99": ttft.percentile(99) if ttft.count else None,
            "pool_free_blocks": self.pool.free_blocks,
            "pool_fragmentation_tokens": self.pool.fragmentation_tokens(),
            "achieved_tok_s": self._achieved_tok_s(),
            "prefix_cache_hit_rate": self.pool.prefix_hit_rate(),
            "cached_blocks": self.pool.cached_blocks,
            "prefix_hot": self.pool.hot_prefixes(),
            "prefix_block_size": self.pool.block_size,
            "rollout_experience": self.rollout_experience,
            "learner_steps_overlapped": self.learner_steps_overlapped,
            "weight_sync_generation": self.weight_sync_generation,
        }

    def _achieved_tok_s(self) -> Optional[float]:
        """Generated tokens (finished and in flight) per second of the
        clock since the first non-idle tick; ``None`` until there are both
        tokens and time, so a cold replica never reports a false zero."""
        if self._serve_t0 is None:
            return None
        wall = self.clock() - self._serve_t0
        tokens = (sum(len(r.output) for r in self.finished)
                  + sum(len(r.output) for r in self.in_flight))
        if wall <= 0 or not tokens:
            return None
        return tokens / wall

    def _touch_serving_heartbeat(self, tick: int) -> None:
        """Refresh a supervisor's heartbeat with the serving role block at
        ``heartbeat_interval`` cadence; a no-op unless
        ``DS_ELASTIC_HEARTBEAT_FILE`` is set."""
        if not os.environ.get(HEARTBEAT_ENV):
            return
        touch_heartbeat(min_interval=self.config.heartbeat_interval,
                        payload={"role": "serving", "tick": tick,
                                 "slots_in_flight": len(self.in_flight),
                                 "queue_depth": len(self.queue),
                                 "last_tick_monotonic": time.monotonic()})

    # -- prefill -------------------------------------------------------
    def _prefill_tick(self, slots: List[int]) -> None:
        chunk = self.config.prefill_chunk
        ids = np.zeros((self.slots, chunk), np.int64)
        last_idx = np.full(self.slots, chunk - 1, np.int64)
        write_pos = np.full(self.slots, self.capacity, np.int64)
        rems: Dict[int, int] = {}
        for i in slots:
            req = self._slot_req[i]
            part = req.prompt[req.prefill_pos:req.prefill_pos + chunk]
            rems[i] = rem = len(part)
            ids[i, :rem] = part
            last_idx[i] = rem - 1
            write_pos[i] = self._lengths[i]
        ids_t = host_to_device(ids, self.device)
        last_t = host_to_device(last_idx, self.device)
        tok = self.fns["prefill"](stamp_lengths(self._cache, write_pos), ids_t, last_t,
                                  *self._sampling_args())
        if self._drafter is not None:
            self.dfns["prefill"](stamp_lengths(self._drafter_cache, write_pos), ids_t, last_t)
        with self._span("serve_device_wait"):
            tok = tok.cpu().numpy()
        now = self.clock()
        for i in slots:
            req, rem = self._slot_req[i], rems[i]
            req.prefill_pos += rem
            self._lengths[i] += rem
            self.pool.advance(req.request_id, rem)
            if req.prefill_pos >= req.prompt_len:
                # prompt complete: the chunk's last real position gave the
                # first new token, so TTFT stops here; the committed prompt's
                # full blocks enter the index for the next same-prefix request
                self._publish_prefix(i, req)
                req.state = ACTIVE
                req.record_token(int(tok[i]), now)
                self._next_token[i] = tok[i]
                self._maybe_finish(i, now)

    # -- plain decode --------------------------------------------------
    def _decode_tick(self, slots: List[int]) -> None:
        write_pos = np.full(self.slots, self.capacity, np.int64)
        tokens = np.zeros(self.slots, np.int64)
        for i in slots:
            write_pos[i] = self._lengths[i]
            tokens[i] = self._next_token[i]
        tok = self.fns["decode"](stamp_lengths(self._cache, write_pos),
                                 host_to_device(tokens, self.device),
                                 *self._sampling_args())
        with self._span("serve_device_wait"):
            tok = tok.cpu().numpy()
        now = self.clock()
        for i in slots:
            req = self._slot_req[i]
            self._lengths[i] += 1  # the fed token's KV is now committed
            self.pool.advance(req.request_id, 1)
            req.record_token(int(tok[i]), now)
            self._next_token[i] = tok[i]
            self._maybe_finish(i, now)

    # -- speculative decode --------------------------------------------
    def _spec_tick(self, slots: List[int]) -> None:
        """One speculation round: k drafter decode steps chained on the
        device, one batched target verify over the k + 1 block, one copy to
        the host of drafts and verdicts (the round's one host sync: every
        host array goes to the card without one), host-side longest-prefix
        acceptance. The drafter re-feeds the block only when some slot
        accepted every draft (its own steps never wrote d_k's KV)."""
        k = self.spec_k
        write_pos = np.full(self.slots, self.capacity, np.int64)
        first = np.zeros(self.slots, np.int64)
        for i in slots:
            write_pos[i] = self._lengths[i]
            first[i] = self._next_token[i]
        first = host_to_device(first, self.device)
        cur = first
        drafts = []
        with self._span("serve_spec_draft"):
            for j in range(k):
                cur = self.dfns["decode"](stamp_lengths(self._drafter_cache, write_pos + j), cur)
                drafts.append(cur)
        block = torch.cat([first[:, None], torch.stack(drafts, dim=1)], dim=1)  # [S, k+1]
        with self._span("serve_spec_verify"):
            greedy = self.fns["verify"](stamp_lengths(self._cache, write_pos), block)
            with self._span("serve_device_wait"):
                both = torch.cat([block[:, 1:], greedy], dim=1).cpu().numpy()
        drafted, greedy = both[:, :k], both[:, k:]  # [S, k] drafts, [S, k+1] target argmax
        refeed = False
        now = self.clock()
        for i in slots:
            req = self._slot_req[i]
            a = 0  # the longest draft prefix the target reproduces
            while a < k and drafted[i, a] == greedy[i, a]:
                a += 1
            emitted = list(drafted[i, :a]) + [greedy[i, a]]
            req.drafted_tokens += k
            req.accepted_tokens += a
            self.drafted_total += k
            self.accepted_total += a
            if a == k:
                refeed = True  # the drafter never wrote d_k's KV
            # budget / eos truncation
            emitted = emitted[:req.max_new_tokens - len(req.output)]
            if req.eos_token_id is not None and req.eos_token_id in emitted:
                emitted = emitted[:emitted.index(req.eos_token_id) + 1]
            for t in emitted:
                req.record_token(int(t), now)
            # committed KV: the fed block prefix [last, d_1..d_{m-1}]
            self._lengths[i] += len(emitted)
            self.pool.advance(req.request_id, len(emitted))
            self._next_token[i] = emitted[-1]
            self._maybe_finish(i, now)
        if refeed and any(self._slot_req[i] is not None for i in slots):
            with self._span("serve_spec_refeed"):
                self.dfns["verify"](stamp_lengths(self._drafter_cache, write_pos), block)

    # -- retire --------------------------------------------------------
    def _maybe_finish(self, slot: int, now: float) -> None:
        req = self._slot_req[slot]
        done = len(req.output) >= req.max_new_tokens
        if req.eos_token_id is not None and req.output and req.output[-1] == req.eos_token_id:
            done = True
        if not done:
            return
        req.state = FINISHED
        req.finish_time = now
        # index prompt + output before the free, so the freed blocks park on
        # the cached LRU instead of returning to the free list
        self._publish_prefix(slot, req)
        self._no_publish.discard(req.request_id)
        self.pool.free(req.request_id)
        self._slot_req[slot] = None
        self._lengths[slot] = self.capacity  # park
        self.finished.append(req)
        if req.ttft is not None:
            self.ttft_hist.record(req.ttft)
        for prev, cur in zip(req.token_times, req.token_times[1:]):
            self.tok_hist.record(cur - prev)
        if self.telemetry is not None:
            self.telemetry.emit("serve_request", **req.stats())

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------
    def run_until_drained(self, max_ticks: int = 10**9, admit: bool = True) -> int:
        """Tick until queue + slots are empty; returns ticks run."""
        n = 0
        while (self.in_flight or len(self.queue)) and n < max_ticks:
            self.step(admit=admit)
            n += 1
        return n

    def serve(self, requests=(), guard=None, migrate=None) -> int:
        """Serve ``requests`` to completion under a preemption guard (one
        of its own on SIGTERM/SIGINT unless ``guard`` is given).

        On a signal the drain contract holds: stop admitting, refuse
        everything still queued, finish every request in flight, and return
        ``DEFAULT_PREEMPT_EXIT_CODE`` (143) so a supervisor reads
        preemption, not success. Returns 0 on a complete drain.

        ``migrate``: an optional ``migrate(scheduler, signal) -> {"migrated":
        int, "bundle": str}`` hook (``fleet.make_bundle_migrate``), tried on
        the signal after the queue is refused. When it returns (it exported
        and released every request in flight) a ``serve_migrate_out`` event
        is emitted and the loop ends without generating more tokens here; on
        :class:`MigrationError` the drain goes on as without it."""
        own_guard = guard is None
        if own_guard:
            guard = PreemptionGuard().install()
        preempted = None
        try:
            for r in requests:
                self.submit(r)
            while self.in_flight or len(self.queue):
                if guard.requested and preempted is None:
                    preempted = guard.consume()
                    refused = self.queue.refuse_all(f"draining on {preempted}")
                    logger.info(f"serve: {preempted}: draining {len(self.in_flight)} in flight, "
                                f"refused {len(refused)} queued")
                    if self.telemetry is not None:
                        self.telemetry.emit("serve_drain", signal=preempted,
                                            in_flight=len(self.in_flight), refused=len(refused))
                    if migrate is not None and self.in_flight:
                        try:
                            out = migrate(self, preempted)
                        except MigrationError as e:
                            logger.info(f"serve: migration refused ({e}); draining instead")
                        else:
                            if self.telemetry is not None:
                                self.telemetry.emit("serve_migrate_out", signal=preempted,
                                                    migrated=int(out.get("migrated", 0)),
                                                    bundle=str(out.get("bundle", "")))
                            continue  # the slots are released: the loop re-checks
                self.step(admit=preempted is None)
        finally:
            if own_guard:
                guard.uninstall()
        return DEFAULT_PREEMPT_EXIT_CODE if preempted else 0

    # ------------------------------------------------------------------
    # live KV migration (the fleet)
    # ------------------------------------------------------------------
    def _kv_slot_leaves(self, slot: int, length: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Host copies of one slot's committed KV rows ``[:length)``, every
        role's KV leaves and their int8 scales: ``{role: {name: rows}}``.
        The rows are read as the prefix cache's publish reads them
        (:meth:`_kv_rows`: one copy a dtype group), so the rows of a leaf
        are a view of that group's fresh host tensor."""
        rows = self._kv_rows(slot, 0, length)
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, roles in self._role_spans().items():
            for role, (lo, _, names) in roles.items():
                for i, name in enumerate(names):
                    out.setdefault(role, {})[name] = rows[key][lo + i]
        return out

    def _validate_slot_kv(self, role: str, leaves: dict, length: int) -> List[tuple]:
        """Check a payload's rows of ``role`` against its cache's KV geometry
        without touching the cache: every KV leaf (and int8 scale) present,
        ``[length, ...]`` of the leaf's row shape and dtype. Raises
        :class:`MigrationError`; returns the writes :meth:`_write_rows`
        applies, one stacked host tensor a dtype group."""
        cache = dict(self._roles())[role]
        writes = []
        for key, roles in self._role_spans().items():
            names = roles.get(role, (0, 0, ()))[2]
            rows = []
            for name in names:
                src = leaves.get(name)
                if src is None:
                    raise MigrationError(f"migration payload missing {role} KV leaf {name}")
                src = torch.as_tensor(src)
                want = (length,) + key[1]
                if tuple(src.shape) != want or src.dtype != key[0]:
                    raise MigrationError(
                        f"{role} KV leaf {name} mismatch: payload {src.dtype}{tuple(src.shape)} vs "
                        f"cache row {key[0]}{want}: replicas must share kv_quant and geometry "
                        f"to migrate")
                rows.append(src)
            if rows:
                writes.append((cache, names, torch.stack(rows)))
        return writes

    def export_inflight(self, release: bool = True) -> List[dict]:
        """Every in-flight request as a migration payload: its host
        bookkeeping and its committed KV rows (both roles when speculating),
        which a peer's :meth:`admit_migrated` restores bit for bit.

        Raises :class:`MigrationError`, before any slot is released, under
        sampled decoding (the sampling generator is the scheduler's, not the
        request's) or for a request outside ``MIGRATABLE_STATES``. Each
        payload carries the compat envelope the importer checks: ``kv_quant``,
        ``weight_dtype``, ``capacity``, ``spec_k``, ``prefix_cache``.
        ``release=True`` frees the exported requests' blocks and parks their
        slots (:meth:`release_inflight`)."""
        if self.config.do_sample:
            raise MigrationError("sampled decoding cannot migrate: the sampling generator is the "
                                 "scheduler's, not the request's; drain instead")
        for req in self.in_flight:
            if req.state not in MIGRATABLE_STATES:
                raise MigrationError(f"request {req.request_id} in state {req.state!r} is not "
                                     f"migratable")
        payloads: List[dict] = []
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            length = int(self._lengths[slot])
            payloads.append({
                "request_id": req.request_id, "state": req.state,
                "prompt": np.asarray(req.prompt, np.int32),
                "max_new_tokens": req.max_new_tokens, "eos_token_id": req.eos_token_id,
                "arrival_time": req.arrival_time, "output": list(req.output),
                "prefill_pos": req.prefill_pos, "first_token_time": req.first_token_time,
                "token_times": list(req.token_times), "drafted_tokens": req.drafted_tokens,
                "accepted_tokens": req.accepted_tokens, "meta": dict(req.meta),
                "length": length, "next_token": int(self._next_token[slot]),
                "cached_prefix_tokens": req.cached_prefix_tokens,
                # the compat envelope: the rows below are the slot's own
                # (shared prefix blocks travel as bytes, not references), but
                # the receiving pool must hash them under the same envelope
                "kv_quant": self.kv_quant, "weight_dtype": self.weight_dtype,
                "capacity": self.capacity, "spec_k": self.spec_k,
                "prefix_cache": self.prefix_cache,
                "kv": self._kv_slot_leaves(slot, length),
            })
        if release:
            self.release_inflight()
        return payloads

    def release_inflight(self) -> int:
        """Free every in-flight request's blocks and park its slot: the half
        of a migration out that follows a published bundle, so that a failed
        save leaves the requests here to drain. Returns how many."""
        n = 0
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._no_publish.discard(req.request_id)
            self.pool.free(req.request_id)
            self._slot_req[slot] = None
            self._lengths[slot] = self.capacity  # park
            n += 1
        return n

    def admit_migrated(self, payload: dict) -> Optional[Request]:
        """Admit one migrated request into a free slot and restore its KV.

        Returns the local :class:`Request`, or ``None`` when this replica has
        no free slot or no blocks for the request's worst case: a capacity
        refusal the router retries elsewhere. A compat mismatch (kv_quant,
        weight dtype, speculation, capacity, prefix cache) or rows of the
        wrong geometry raise :class:`MigrationError`, which no retry fixes;
        every role's rows are checked before any is written, so a refusal
        leaves the scheduler untouched. The request gets a fresh local id
        (every replica counts from 0), its origin id in
        ``meta["migrated_from"]``. The slot's write position and next token
        are host state stamped onto the card every tick, so setting the host
        mirror is the whole of the slot's reset."""
        for knob in ("kv_quant", "weight_dtype", "spec_k", "capacity", "prefix_cache"):
            if payload.get(knob) != getattr(self, knob):
                raise MigrationError(f"migration compat mismatch on {knob}: bundle "
                                     f"{payload.get(knob)!r} vs replica {getattr(self, knob)!r}")
        if payload["state"] not in MIGRATABLE_STATES:
            raise MigrationError(f"bundle request state {payload['state']!r} is not migratable")
        free = self._free_slots()
        if not free:
            return None
        req = Request(prompt=payload["prompt"], max_new_tokens=payload["max_new_tokens"],
                      eos_token_id=payload["eos_token_id"], arrival_time=payload["arrival_time"])
        if not self.pool.can_allocate(req.total_tokens):
            return None
        length = int(payload["length"])
        kv = payload["kv"]
        writes = []
        for role, _ in self._roles():
            writes += self._validate_slot_kv(role, kv.get(role, {}), length)
        req.meta.update(payload.get("meta", {}))
        req.meta["migrated_from"] = payload["request_id"]
        req.state = payload["state"]
        req.output = [int(t) for t in payload["output"]]
        req.prefill_pos = int(payload["prefill_pos"])
        req.first_token_time = payload["first_token_time"]
        req.token_times = list(payload["token_times"])
        req.drafted_tokens = int(payload["drafted_tokens"])
        req.accepted_tokens = int(payload["accepted_tokens"])
        req.cached_prefix_tokens = int(payload.get("cached_prefix_tokens", 0))
        slot = free[0]
        self._write_rows(slot, length, writes)
        self.pool.reserve(req.request_id, req.total_tokens)
        self.pool.advance(req.request_id, length)
        self._slot_req[slot] = req
        self._lengths[slot] = length
        self._next_token[slot] = int(payload["next_token"])
        if self.telemetry is not None:
            self.telemetry.emit("serve_admit_migrated", request_id=req.request_id,
                                migrated_from=payload["request_id"], state=req.state,
                                length=length)
        return req

    # -- the RLHF weight hot-swap (JAX ``scheduler.py:608-688``) ---------
    @torch.no_grad()
    def swap_served_params(self, params: Dict[str, torch.Tensor],
                           expected_digest: Optional[str] = None,
                           generation: Optional[int] = None,
                           evidence: Optional[dict] = None) -> None:
        """Hot-swap the served weights between ticks: copy ``params`` (a
        state dict of the engine module's names, shapes and dtypes) into
        the served module's tensors in place, so the next tick serves them.
        KV already written stays (in-flight requests finish on the new
        weights, the in-flight RLHF staleness contract).

        A drifted state dict (names, shapes or dtypes) raises
        ``ValueError`` before anything is written. Under ``weight_dtype``
        int8/int4 the weights are re-encoded into the served codes and
        scales, and ``expected_digest`` raises (the re-encode is lossy by
        design). Otherwise, with ``expected_digest``, the served weights
        are re-digested after the copy and a mismatch raises; when every
        served tensor already is the tensor given (a scheduler over the
        hybrid engine's own view) nothing is placed, and a digest that
        ``evidence["digest"]`` computed over those tensors stands without
        hashing them again (``last_weight_sync["placed"]`` is False). Bumps
        ``weight_sync_generation`` (or sets ``generation``), records
        ``last_weight_sync`` and emits ``rlhf_weight_sync``. The prefix
        cache serves no KV row computed under the old weights after the
        swap (the JAX scheduler keeps matching them)."""
        from deepspeed_tpu_torch.runtime.rlhf.sync import params_digest

        if self.weight_dtype != "fp" and expected_digest is not None:
            raise ValueError(f"digest verification is meaningless under a quantized weight view "
                             f"(wq={self.weight_dtype}): the served params are a lossy re-encode "
                             f"of what the learner published; pass expected_digest=None")
        ref = self.engine.module.state_dict()
        if set(params) != set(ref):
            raise ValueError("swap_served_params: leaf drift: the new state dict's names differ "
                             f"from the served ones (missing {sorted(set(ref) - set(params))[:5]}, "
                             f"extra {sorted(set(params) - set(ref))[:5]})")
        problems = [f"{k}: served {tuple(v.shape)}/{v.dtype} vs new "
                    f"{tuple(params[k].shape)}/{params[k].dtype}"
                    for k, v in ref.items()
                    if params[k].shape != v.shape or params[k].dtype != v.dtype]
        if problems:
            raise ValueError("swap_served_params: leaf drift — " + "; ".join(problems[:5]))
        if self.weight_dtype != "fp":
            params = _quant_state(params, self.weight_dtype, self.config.weight_group_size)
        served = self.module.state_dict()
        placed = False
        for name, dst in served.items():
            src = params[name]
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
                placed = True
        digest_verified = expected_digest is not None
        if digest_verified and (placed or (evidence or {}).get("digest") != expected_digest):
            got = params_digest(served)
            if got != expected_digest:
                raise ValueError(f"swap_served_params: digest mismatch after placement — learner "
                                 f"published {expected_digest[:16]}… but the served params digest "
                                 f"to {got[:16]}…")
        self.weight_sync_generation = (generation if generation is not None
                                       else self.weight_sync_generation + 1)
        # KV rows computed under the old weights are never restored for the
        # new ones: later prefixes hash under a new envelope, and a request
        # in flight now (its rows span both) publishes nothing more
        self.pool.envelope = f"{self._envelope}/wsync:{self.weight_sync_generation}"
        self._no_publish.update(r.request_id for r in self.in_flight)
        self.last_weight_sync = dict(evidence or {}, digest_verified=digest_verified, placed=placed)
        if self.telemetry is not None:
            ev = evidence or {}
            self.telemetry.emit("rlhf_weight_sync", generation=self.weight_sync_generation,
                                gather_bytes=ev.get("gather_bytes"),
                                total_bytes=ev.get("total_bytes"),
                                digest_verified=digest_verified, in_flight=len(self.in_flight))

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Aggregate serving evidence: latency distributions, speculation
        acceptance, pool accounting, tick mix."""
        done = self.finished
        pool = dict(self.pool.counters())
        block_bytes = max(1, int(round(self._kv_bytes_per_token() * self.pool.block_size)))
        pool["kv_block_bytes"] = block_bytes
        pool["kv_blocks_per_gb"] = (1 << 30) // block_bytes
        out = {
            "finished": len(done),
            "refused": self.queue.refused,
            "generated_tokens": sum(len(r.output) for r in done),
            "ticks": dict(self.ticks),
            "pool": pool,
            "kv_write": self.kv_write,
            "weight_dtype": self.weight_dtype,
            "kv_quant": self.kv_quant,
            "prefix_cache": self.prefix_cache,
            "cached_prefix_tokens": sum(r.cached_prefix_tokens for r in done),
            "ttft": self.ttft_hist.snapshot() if self.ttft_hist.count else None,
            "per_token": self.tok_hist.snapshot() if self.tok_hist.count else None,
        }
        if self.spec_k:
            out["spec_k"] = self.spec_k
            out["drafted"] = self.drafted_total
            out["accepted"] = self.accepted_total
            out["acceptance_rate"] = (self.accepted_total / self.drafted_total
                                      if self.drafted_total else None)
        if self.rollout_experience or self.weight_sync_generation or self.learner_steps_overlapped:
            # RLHF rollout evidence, present once an RLHF loop served here
            out["rollout"] = {"experience": self.rollout_experience,
                              "learner_steps_overlapped": self.learner_steps_overlapped,
                              "weight_sync_generation": self.weight_sync_generation,
                              "last_weight_sync": self.last_weight_sync}
        return out
