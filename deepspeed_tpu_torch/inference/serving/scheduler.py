"""Continuous in-flight batching over the per-slot decode cache
(counterpart of ``deepspeed_tpu/inference/serving/scheduler.py``).

One scheduler drives one :class:`InferenceEngine` through two fixed-shape
steps (``serving/programs.py``): requests join and leave decode slots on
every tick, and chunked prefill interleaves long prompts with in-flight
decodes. Admission is block-pool truthful (``queue.py``): a request is
admitted only when its worst-case KV footprint is reservable, so nothing
dies mid-flight and nothing leaks.

Host protocol: the scheduler's numpy ``lengths`` mirror is authoritative.
Every tick stamps it into the cache's index leaves; a parked slot carries
the sentinel position (= slot capacity) so its writes drop.

With ``weight_dtype`` int8/int4 every projection runs kernel K2 over
per-group codes; every tick's attention runs kernel K3 when the engine was
built with the flash backend. Live migration, RLHF weight swap, telemetry,
prefix caching and speculative decoding are later slices of the port.
"""

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.serving.blocks import BlockPool
from deepspeed_tpu_torch.inference.serving.config import ServingConfig
from deepspeed_tpu_torch.inference.serving.programs import (build_decode_step, build_prefill_step,
                                                            make_apply_fn, make_slot_cache,
                                                            slot_capacity, stamp_lengths)
from deepspeed_tpu_torch.inference.serving.queue import RequestQueue
from deepspeed_tpu_torch.inference.serving.request import ACTIVE, FINISHED, PREFILL, Request
from deepspeed_tpu_torch.models.common import flatten_tree, nest_tree
from deepspeed_tpu_torch.ops.quantizer.weights import quantize_params


def _quant_view(module, weight_dtype: str, group_size: int):
    """The weight-quantized serving module: the same architecture rebuilt
    with ``serve_weight_dtype`` set, holding per-group codes and scales
    (``ops/quantizer/weights.quantize_params``) of ``module``'s weights.
    The engine's own module keeps its fp weights."""
    cfg = getattr(module, "config", None)
    if cfg is None or not any(f.name == "serve_weight_dtype" for f in dataclasses.fields(cfg)):
        raise NotImplementedError(f"{type(module).__name__} does not declare the "
                                  f"serve_weight_dtype seam for weight-quantized serving")
    q_cfg = dataclasses.replace(cfg, serve_weight_dtype=weight_dtype,
                                serve_weight_group_size=group_size)
    q_module = type(module)(q_cfg, device=module.device)
    qparams, qscales = quantize_params(nest_tree(module.state_dict(), "."), weight_dtype,
                                       group_size)
    state = flatten_tree(qparams, ".")
    state.update(flatten_tree(qscales, "."))
    q_module.load_state_dict(state, strict=True)
    return q_module


def _summary(values: List[float]) -> Optional[dict]:
    if not values:
        return None
    arr = np.asarray(values, np.float64)
    return {"count": int(arr.size), "mean": float(arr.mean()),
            "p50": float(np.percentile(arr, 50)), "p99": float(np.percentile(arr, 99)),
            "max": float(arr.max())}


class ContinuousBatchingScheduler:
    """Continuous (in-flight) batching over one engine.

    ``clock``: injectable time source (``time.monotonic`` by default); tests
    drive a simulated clock. ``seed`` seeds the sampling generator."""

    def __init__(self, engine, config=None, clock: Optional[Callable[[], float]] = None,
                 seed: int = 0):
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
        self.config = config
        self.engine = engine
        self.device = engine.device
        self.clock = clock or time.monotonic
        self.weight_dtype = config.resolved_weight_dtype
        self.kv_quant = bool(config.kv_quant)
        self.module = engine.module
        if self.weight_dtype != "fp":
            self.module = _quant_view(engine.module, self.weight_dtype, config.weight_group_size)

        # pow2 slot bucket, as the JAX scheduler
        self.slots = engine._pow2_bucket(config.slots)
        self._cache = make_slot_cache(self.module, self.slots, kv_quant=self.kv_quant)
        self.capacity = slot_capacity(self._cache)  # tokens per slot

        pool_tokens = config.kv_pool_tokens or self.slots * self.capacity
        self.pool = BlockPool(num_blocks=max(1, pool_tokens // config.page_size),
                              block_size=config.page_size)
        self.queue = RequestQueue(self.pool, max_queue=config.max_queue,
                                  max_total_tokens=self.capacity, clock=self.clock)
        apply_fn = make_apply_fn(self.module)
        sampling = dict(do_sample=config.do_sample, temperature=config.temperature,
                        top_k=config.top_k, top_p=config.top_p)
        self.fns = {"prefill": build_prefill_step(apply_fn, **sampling),
                    "decode": build_decode_step(apply_fn, **sampling)}

        # host-side authoritative slot state
        self._slot_req: List[Optional[Request]] = [None] * self.slots
        self._lengths = np.full(self.slots, self.capacity, np.int64)  # parked sentinel
        self._next_token = np.zeros(self.slots, np.int64)
        self._decode_ticks_since_prefill = 10**9  # the first prefill never waits
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

        self.ttft: List[float] = []
        self.per_token: List[float] = []
        self.ticks = {"prefill": 0, "decode": 0, "idle": 0}
        self.finished: List[Request] = []

    def _sampling_args(self):
        return (self._generator,) if self.config.do_sample else ()

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Run each step once against fully parked slots (every KV write
        drops, outputs are discarded), so the kernels are built and loaded
        before the first request is timed. Touches no request accounting."""
        parked = np.full(self.slots, self.capacity, np.int64)
        chunk = self.config.prefill_chunk
        ids = torch.zeros((self.slots, chunk), dtype=torch.int64, device=self.device)
        last_idx = torch.zeros((self.slots,), dtype=torch.int64, device=self.device)
        tok = torch.zeros((self.slots,), dtype=torch.int64, device=self.device)
        gen = (torch.Generator(device=self.device).manual_seed(0),) if self.config.do_sample else ()
        self.fns["prefill"](stamp_lengths(self._cache, parked), ids, last_idx, *gen)
        self.fns["decode"](stamp_lengths(self._cache, parked), tok, *gen)

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
            self._lengths[slot] = 0
            req.state = PREFILL
            req.prefill_pos = 0
        return len(admitted)

    # ------------------------------------------------------------------
    def step(self, admit: bool = True) -> str:
        """One scheduler tick; returns the tick kind it ran
        (``prefill`` | ``decode`` | ``idle``)."""
        if admit:
            self._admit()
        prefilling = [i for i, r in enumerate(self._slot_req) if r is not None and r.state == PREFILL]
        active = [i for i, r in enumerate(self._slot_req) if r is not None and r.state == ACTIVE]
        if prefilling and (not active or self._decode_ticks_since_prefill
                           >= self.config.prefill_interleave):
            kind = "prefill"
            self._prefill_tick(prefilling)
            self._decode_ticks_since_prefill = 0
        elif active:
            kind = "decode"
            self._decode_tick(active)
            self._decode_ticks_since_prefill += 1
        else:
            kind = "idle"
        self.ticks[kind] += 1
        return kind

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
        cache = stamp_lengths(self._cache, write_pos)
        tok = self.fns["prefill"](cache, torch.as_tensor(ids, device=self.device),
                                  torch.as_tensor(last_idx, device=self.device),
                                  *self._sampling_args())
        tok = tok.cpu().numpy()
        now = self.clock()
        for i in slots:
            req, rem = self._slot_req[i], rems[i]
            req.prefill_pos += rem
            self._lengths[i] += rem
            self.pool.advance(req.request_id, rem)
            if req.prefill_pos >= req.prompt_len:
                # prompt complete: the chunk's last real position gave the
                # first new token, so TTFT stops here
                req.state = ACTIVE
                req.record_token(int(tok[i]), now)
                self._next_token[i] = tok[i]
                self._maybe_finish(i, now)

    def _decode_tick(self, slots: List[int]) -> None:
        write_pos = np.full(self.slots, self.capacity, np.int64)
        tokens = np.zeros(self.slots, np.int64)
        for i in slots:
            write_pos[i] = self._lengths[i]
            tokens[i] = self._next_token[i]
        cache = stamp_lengths(self._cache, write_pos)
        tok = self.fns["decode"](cache, torch.as_tensor(tokens, device=self.device),
                                 *self._sampling_args())
        tok = tok.cpu().numpy()
        now = self.clock()
        for i in slots:
            req = self._slot_req[i]
            self._lengths[i] += 1  # the fed token's KV is now committed
            self.pool.advance(req.request_id, 1)
            req.record_token(int(tok[i]), now)
            self._next_token[i] = tok[i]
            self._maybe_finish(i, now)

    def _maybe_finish(self, slot: int, now: float) -> None:
        req = self._slot_req[slot]
        done = len(req.output) >= req.max_new_tokens
        if req.eos_token_id is not None and req.output and req.output[-1] == req.eos_token_id:
            done = True
        if not done:
            return
        req.state = FINISHED
        req.finish_time = now
        self.pool.free(req.request_id)
        self._slot_req[slot] = None
        self._lengths[slot] = self.capacity  # park
        self.finished.append(req)
        if req.ttft is not None:
            self.ttft.append(req.ttft)
        self.per_token.extend(cur - prev for prev, cur in zip(req.token_times, req.token_times[1:]))

    # ------------------------------------------------------------------
    def run_until_drained(self, max_ticks: int = 10**9, admit: bool = True) -> int:
        """Tick until queue + slots are empty; returns ticks run."""
        n = 0
        while (self.in_flight or len(self.queue)) and n < max_ticks:
            self.step(admit=admit)
            n += 1
        return n

    def serve(self, requests=()) -> int:
        """Submit ``requests`` and serve until queue and slots are empty.
        Returns 0 (the JAX scheduler's preemption drain is later work)."""
        for r in requests:
            self.submit(r)
        self.run_until_drained()
        return 0

    def stats(self) -> dict:
        """Aggregate serving evidence: latency distributions, pool
        accounting, tick mix."""
        return {
            "finished": len(self.finished),
            "refused": self.queue.refused,
            "generated_tokens": sum(len(r.output) for r in self.finished),
            "ticks": dict(self.ticks),
            "pool": self.pool.counters(),
            "weight_dtype": self.weight_dtype,
            "kv_quant": self.kv_quant,
            "ttft": _summary(self.ttft),
            "per_token": _summary(self.per_token),
        }
