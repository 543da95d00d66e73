"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

A remat policy names what a checkpointed block keeps from its forward for
the backward; the rest is recomputed. JAX's six names map onto
``torch.utils.checkpoint.create_selective_checkpoint_contexts``, decided op
by op at dispatch:

* ``nothing_saveable``: every op recomputed (plain ``checkpoint``, the
  full recompute of ``remat_policy=None``);
* ``everything_saveable``: every op's output kept, so nothing is recomputed
  but the region's Python (and the kernels it launches);
* ``dots_saveable`` and its alias ``checkpoint_dots``: the outputs of
  ``aten.mm``, ``addmm``, ``bmm`` and ``matmul`` kept, the elementwise
  work recomputed;
* ``dots_with_no_batch_dims_saveable`` and its alias
  ``checkpoint_dots_with_no_batch_dims``: ``mm`` and ``addmm`` kept, a
  batched ``bmm`` (attention's products, MoE experts') recomputed.

A hand-written kernel (K1's flash forward, K5's permutation) is no aten
product and is recomputed under every policy but ``everything_saveable``,
as a ``pallas_call`` is no ``dot_general`` to JAX's policies.

``configure`` and ``checkpoint`` are the module-level surface user code
calls. ``partition_activations``, ``contiguous_memory_optimization``,
``synchronize_checkpoint_boundary`` and ``profile`` are taken as JAX takes
them: on one card there is nothing to partition, and the caching allocator
owns contiguity.

``cpu_checkpointing`` applies where JAX applies it: in :func:`checkpoint`
when no policy is configured (JAX's ``offload_dot_with_no_batch_dims(
"device", "pinned_host")``; the models' remat ignores it, as JAX's does).
The outputs of the products with no batch dims (``aten.mm``, ``addmm``)
are copied to pinned host memory on a side stream as the forward makes
them; the recompute in the backward takes them back from there, ordered
by events, and recomputes the rest (torch stops a recompute after the
last op its backward needs, so a product that no backward reads, such as a
block's last one, is copied and never taken back). Torch's selective-checkpoint cache
keeps what it saves on the card, and ``torch.autograd.graph.save_on_cpu``
never sees that cache, so the host cache is a pair of dispatch modes of
its own (:func:`host_offload_contexts`).
"""

import contextlib
import functools
import logging
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint as torch_checkpoint,
                                    create_selective_checkpoint_contexts)

logger = logging.getLogger(__name__)

_ATEN = torch.ops.aten
#: the products each dots policy keeps
_DOTS = (_ATEN.mm.default, _ATEN.addmm.default, _ATEN.bmm.default, _ATEN.matmul.default)
_DOTS_NO_BATCH = (_ATEN.mm.default, _ATEN.addmm.default)

#: policy name -> the ops it saves ("all", none, or a tuple of op overloads)
POLICIES = {
    "everything_saveable": "all",
    "nothing_saveable": (),
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
}


def get_remat_policy(name: Optional[str]):
    """A policy name's saved ops (``"all"`` or a tuple); None is the full
    recompute. Raises ``ValueError`` for an unknown name, as JAX does."""
    if name is None:
        return None
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; choose from {sorted(POLICIES)}")
    return POLICIES[name]


def _policy_fn(saved, ctx, op, *args, **kwargs):
    if saved == "all" or op in saved:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _context_fn(saved):
    # a kernel that writes its own outputs (the in-place fills of the MoE
    # route's buffers) may touch a kept tensor: the kept value is the one
    # the backward reads, as in plain autograd
    return create_selective_checkpoint_contexts(functools.partial(_policy_fn, saved),
                                                allow_cache_entry_mutation=True)


#: products ``cpu_checkpointing`` has copied to the host since the process
#: started: their count and bytes
OFFLOADED = {"products": 0, "bytes": 0}


class _OffloadProducts(TorchDispatchMode):
    """The forward's mode: each no-batch-dims product's output is copied
    to the host (pinned, on a side stream, behind an event, for a CUDA
    tensor) and queued."""

    def __init__(self, storage: list):
        super().__init__()
        self.storage = storage
        self.stream = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in _DOTS_NO_BATCH:
            return out
        if out.is_cuda:
            host = torch.empty(out.shape, dtype=out.dtype, device="cpu", pin_memory=True)
            if self.stream is None:
                self.stream = torch.cuda.Stream(out.device)
            self.stream.wait_stream(torch.cuda.current_stream(out.device))
            with torch.cuda.stream(self.stream):
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            out.record_stream(self.stream)  # the block outlives the copy
        else:
            host, done = out.clone(), None
        OFFLOADED["products"] += 1
        OFFLOADED["bytes"] += host.numel() * host.element_size()
        self.storage.append((host, done))
        return out


class _ReloadProducts(TorchDispatchMode):
    """The recompute's mode: each no-batch-dims product takes its output
    back from the host queue, in the forward's order, instead of running;
    every other op runs."""

    def __init__(self, storage: list):
        super().__init__()
        self.storage = storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _DOTS_NO_BATCH:
            return func(*args, **(kwargs or {}))
        if not self.storage:
            raise RuntimeError(f"cpu_checkpointing: the recompute ran {func} more often than the "
                               f"forward did")
        host, done = self.storage.pop(0)
        device = args[0].device
        if done is None:
            return host.to(device)
        torch.cuda.current_stream(device).wait_event(done)
        return host.to(device, non_blocking=True)


def host_offload_contexts():
    """``context_fn`` of ``torch.utils.checkpoint``: the forward and
    recompute modes of one region, sharing its host queue."""
    storage: list = []
    return _OffloadProducts(storage), _ReloadProducts(storage)


def checkpoint_with_policy(function: Callable, *args, policy: Optional[str] = None) -> Any:
    """``function(*args)`` under non-reentrant activation checkpointing with
    remat ``policy`` (None: full recompute)."""
    saved = get_remat_policy(policy)
    kwargs = {}
    if saved:
        kwargs["context_fn"] = functools.partial(_context_fn, saved)
    return torch_checkpoint(function, *args, use_reentrant=False, **kwargs)


class _State:
    configured = False
    partition_activations = False
    contiguous_checkpointing = False
    cpu_checkpointing = False
    num_checkpoints: Optional[int] = None
    synchronize = False
    profile = False
    policy_name: Optional[str] = None


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, checkpoint_in_cpu=None, synchronize=None,
              profile=None, num_checkpoints=None, policy: Optional[str] = None):
    """The module-level settings (JAX ``configure``): an explicit argument
    wins over the config dict's ``activation_checkpointing`` block."""
    cfg = {}
    if deepspeed_config is not None:
        raw = deepspeed_config if isinstance(deepspeed_config, dict) else {}
        cfg = raw.get("activation_checkpointing", {}) or {}
    _State.partition_activations = bool(
        partition_activations if partition_activations is not None
        else cfg.get("partition_activations", False))
    _State.contiguous_checkpointing = bool(
        contiguous_checkpointing if contiguous_checkpointing is not None
        else cfg.get("contiguous_memory_optimization", False))
    _State.cpu_checkpointing = bool(
        checkpoint_in_cpu if checkpoint_in_cpu is not None
        else cfg.get("cpu_checkpointing", False))
    _State.num_checkpoints = (num_checkpoints if num_checkpoints is not None
                              else cfg.get("number_checkpoints"))
    _State.synchronize = bool(synchronize if synchronize is not None
                              else cfg.get("synchronize_checkpoint_boundary", False))
    _State.profile = bool(profile if profile is not None else cfg.get("profile", False))
    _State.policy_name = policy or cfg.get("policy")
    get_remat_policy(_State.policy_name)
    _State.configured = True
    logger.info(f"activation checkpointing configured: policy="
                f"{_State.policy_name or 'full-recompute'} cpu={_State.cpu_checkpointing} "
                f"partition={_State.partition_activations}")


def is_configured() -> bool:
    return _State.configured


def reset():
    """Clear the module settings (JAX ``reset``)."""
    for k, v in vars(_State).items():
        if not k.startswith("__"):
            setattr(_State, k, False if isinstance(v, bool) else None)
    _State.configured = False


class _RNGStatesTracker:
    """Named generators with a ``fork`` context (JAX's tracker of named
    keys; upstream ``CudaRNGStatesTracker``). ``fork`` makes the named
    generator the default one for its block and saves its advanced state
    on exit, so Megatron-style code that draws inside ``fork()`` runs
    unchanged; a checkpointed region replays its draws because
    ``torch.utils.checkpoint`` restores the default generator's state."""

    def __init__(self):
        self._states = {}

    def get_states(self):
        return dict(self._states)

    def set_states(self, states):
        self._states = dict(states)

    def add(self, name, seed):
        if name in self._states:
            raise Exception(f"rng state {name} already exists")
        self._states[name] = torch.Generator().manual_seed(int(seed)).get_state()

    def reset(self):
        self._states = {}

    @contextlib.contextmanager
    def fork(self, name="model-parallel-rng"):
        if name not in self._states:
            raise Exception(f"rng state {name} is not added")
        outer = torch.get_rng_state()
        torch.set_rng_state(self._states[name])
        try:
            yield
        finally:
            self._states[name] = torch.get_rng_state()
            torch.set_rng_state(outer)


_RNG_TRACKER = _RNGStatesTracker()


def get_rng_state_tracker() -> _RNGStatesTracker:
    return _RNG_TRACKER


def model_parallel_cuda_manual_seed(seed):
    """Seed the tracker's model-parallel stream at ``seed + 2718`` (JAX
    drops upstream's per-tensor-rank offset: one card, one rank)."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("model-parallel-rng", int(seed) + 2718)


def checkpoint(function: Callable, *args) -> Any:
    """Checkpoint a function call (JAX ``checkpoint``): the backward
    recomputes ``function`` under the configured policy; with
    ``cpu_checkpointing`` and no policy, the products with no batch dims
    come back from pinned host memory instead of being recomputed."""
    if _State.cpu_checkpointing and get_remat_policy(_State.policy_name) is None:
        return torch_checkpoint(function, *args, use_reentrant=False,
                                context_fn=host_offload_contexts)
    return checkpoint_with_policy(function, *args, policy=_State.policy_name)


class CheckpointFunction:
    """``CheckpointFunction.apply(run_function, *args)``: :func:`checkpoint`."""

    @staticmethod
    def apply(run_function, *args):
        return checkpoint(run_function, *args)
