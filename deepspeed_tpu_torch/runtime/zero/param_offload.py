"""ZeRO-Infinity parameter offload (``offload_param``): the parameters rest
off the card and stream through it, block by block (counterpart of
``deepspeed_tpu/runtime/zero/param_offload.py``).

The JAX package rests every leaf in ``pinned_host`` memory and streams it
with a ``custom_vjp`` around a memory-kind ``device_put``, placed inside
each block's ``jax.checkpoint`` region. The port keeps that design in
PyTorch's terms:

1. Resting place: every parameter is an fp32 tensor on the host (pinned
   when ``offload_param.pin_memory``, JAX's default ``False``). The module
   still holds them as its ``Parameter`` objects, so ``named_parameters()``,
   ``state_dict()`` and ``save_16bit_model`` see every weight.
2. Streaming in: :func:`stream_in` is a ``torch.autograd.Function`` whose
   forward copies the host tensor to the card and casts it to the compute
   dtype (the cast rides the copy, as JAX's ``param_streaming(cast_dtype=)``
   does), and whose backward ``add_``s the cotangent, in fp32, into that
   leaf's slice of the engine's flat fp32 gradient buffer on the card. The
   cotangent never goes to the host (JAX's identity backward); nothing
   accumulates into the host tensor's ``.grad``.
3. Blocks: ``models/common.maybe_remat`` passes every block through
   :func:`stream_block`, which under an active :func:`param_streaming`
   context runs the block through ``torch.func.functional_call`` on freshly
   streamed copies of its parameters, inside the checkpoint region: the
   recompute streams the block again, and the forward's copies die with the
   block's forward. The leaves outside the blocks (embeddings, the final
   norm, the head) stream once per forward (:func:`stream_top`). A family
   names its block prefix in ``streamed_block_prefixes`` (``("h_",)``,
   ``("layers_",)``). Without the context both are the identity: a model's
   forward is unchanged, bit for bit.
4. NVMe: :class:`PartitionedParamSwapper` journals every leaf to one
   O_DIRECT file under ``<nvme_path>/params`` and keeps at most
   ``max_in_cpu`` bytes on the host between steps.

The copies run on the current stream, in order with the compute (no
prefetch yet). One process only: JAX's ``migrate``, ``local_shard_*`` and
``assemble_from_local_shards`` serve multi-host meshes and belong to the
multi-card slice of the port (ROADMAP.md Queue A item 8).
"""

import contextlib
import re
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.aio.aio_handle import AsyncIOHandle, check_io
from deepspeed_tpu_torch.utils.autograd import once_differentiable

_state = threading.local()


class ParamStreamer:
    """What one engine streams: the card, the compute dtype, each host
    leaf's gradient view (keyed by the leaf's ``id``) and the counters:
    ``copies`` and ``bytes`` streamed in, and with ``timing`` on (CUDA)
    the copies' device ms, read by :meth:`stream_ms`."""

    def __init__(self, device: torch.device, cast_dtype: Optional[torch.dtype],
                 grad_views: Dict[int, torch.Tensor]):
        self.device = device
        self.cast_dtype = cast_dtype
        self.grad_views = grad_views
        self.copies = 0
        self.bytes = 0
        self.timing = False
        self._events: List[tuple] = []

    def reset_counters(self) -> None:
        self.copies = 0
        self.bytes = 0
        self._events = []

    def stream_ms(self) -> float:
        """The device ms of the copies timed since the last reset (waits
        for them)."""
        total = 0.0
        for start, end in self._events:
            end.synchronize()
            total += start.elapsed_time(end)
        return total

    def stream(self, host: torch.Tensor) -> torch.Tensor:
        self.copies += 1
        self.bytes += host.numel() * host.element_size()
        if self.timing and self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = stream_in(host, self.grad_views.get(id(host)), self.device, self.cast_dtype)
            end.record()
            self._events.append((start, end))
            return out
        return stream_in(host, self.grad_views.get(id(host)), self.device, self.cast_dtype)


class _StreamIn(torch.autograd.Function):
    """Differentiable once: its backward adds into the flat gradient buffer
    outside the graph, so a second derivative raises (JAX's ``stream_in``,
    whose backward is the identity, gives one; an HVP under
    ``offload_param`` is out of reach here)."""

    @staticmethod
    def forward(ctx, host, grad_view, device, cast_dtype):
        ctx.grad_view = grad_view
        out = host.to(device, non_blocking=host.is_pinned())
        if cast_dtype is not None and out.is_floating_point():
            out = out.to(cast_dtype)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        if ctx.grad_view is not None:
            ctx.grad_view.add_(ct.to(ctx.grad_view.dtype))
        return None, None, None, None


def stream_in(host: torch.Tensor, grad_view: Optional[torch.Tensor], device: torch.device,
              cast_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``host`` copied to ``device`` (and cast to ``cast_dtype``), as a
    differentiable op whose backward adds the cotangent into ``grad_view``
    (a view of the card's gradient buffer shaped as ``host``) and gives the
    host tensor no gradient."""
    return _StreamIn.apply(host, grad_view, device, cast_dtype)


def active_streamer() -> Optional[ParamStreamer]:
    return getattr(_state, "streamer", None)


@contextlib.contextmanager
def param_streaming(streamer: Optional[ParamStreamer]):
    """Stream parameters through ``streamer`` for the duration of a
    forward (a no-op context for None)."""
    prev = active_streamer()
    _state.streamer = streamer
    try:
        yield streamer
    finally:
        _state.streamer = prev


def _streamed_params(module: torch.nn.Module, streamer: ParamStreamer, skip=None) -> dict:
    return {name: streamer.stream(p) for name, p in module.named_parameters()
            if skip is None or not skip(name)}


def stream_block(block):
    """``block`` itself without an active streamer; with one, a callable
    that runs ``block`` on streamed copies of its parameters, made inside
    the call (so inside a checkpoint region that wraps it)."""
    streamer = active_streamer()
    if streamer is None:
        return block

    def run(*args):
        return torch.func.functional_call(block, _streamed_params(block, streamer), args)

    return run


def block_matcher(prefixes):
    """A predicate on parameter names: True for a leaf of a numbered block
    (``<prefix><digits>.``, e.g. ``h_3.attn.c_attn.kernel`` for ``h_``),
    which streams itself inside its block. The match is the prefix and
    digits in full (JAX's ``stream_tree`` rule), so that ``layer_norm`` is
    not taken for a block of ``layer_``."""
    pats = [re.compile(re.escape(str(p)) + r"\d+") for p in prefixes]

    def is_block_leaf(name: str) -> bool:
        head = name.split(".", 1)[0]
        return any(p.fullmatch(head) for p in pats)

    return is_block_leaf


def stream_top(module: torch.nn.Module, streamer: ParamStreamer) -> dict:
    """Streamed copies of ``module``'s parameters outside its blocks (the
    family's ``streamed_block_prefixes``), for ``functional_call``."""
    return _streamed_params(module, streamer,
                            skip=block_matcher(getattr(module, "streamed_block_prefixes", ())))


class PartitionedParamSwapper:
    """The NVMe resting tier of the parameter leaves (JAX
    ``PartitionedParamSwapper``; upstream
    ``AsyncPartitionedParameterSwapper``): one file per leaf
    (``param_<i>.bin``), O_DIRECT aio with the C++ engine's buffered path
    where the filesystem refuses it, a pipelined fetch. Between steps the
    host holds at most ``window_bytes`` (``offload_param.max_in_cpu``) of
    leaves, the prefix of the leaf order; the rest lives on disk."""

    def __init__(self, swap_dir: str, window_bytes: int = int(1e9), n_threads: int = 4,
                 use_direct: bool = True):
        self.swap_dir = Path(swap_dir)
        self.swap_dir.mkdir(parents=True, exist_ok=True)
        self.window_bytes = int(window_bytes)
        self.read_handle = AsyncIOHandle(n_threads, use_direct=use_direct)
        self.write_handle = AsyncIOHandle(n_threads, use_direct=use_direct)
        self._meta: Dict[int, tuple] = {}  # idx -> (shape, dtype)
        self._resident: Dict[int, np.ndarray] = {}

    def _path(self, idx: int) -> Path:
        return self.swap_dir / f"param_{idx}.bin"

    def initialize(self, leaves: List[np.ndarray]) -> None:
        """Write the first resting copy of every leaf."""
        for i, leaf in enumerate(leaves):
            arr = np.ascontiguousarray(leaf)
            self._meta[i] = (arr.shape, arr.dtype)
            self.write_handle.pwrite(arr.reshape(-1).view(np.uint8), self._path(i))
        errs = self.write_handle.wait()
        check_io(errs, f"param swap-file writes in {self.swap_dir}")

    def fetch_all(self) -> List[np.ndarray]:
        """Every leaf back, pipelined: leaf i+1's read overlaps the
        hand-over of leaf i; window leaves come from RAM."""
        n = len(self._meta)
        out: List[Optional[np.ndarray]] = [None] * n

        def issue(idx):
            shape, dtype = self._meta[idx]
            buf = np.empty(int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize, np.uint8)
            self.read_handle.pread(buf, self._path(idx))
            return idx, buf

        nxt = 0
        while nxt < n and nxt in self._resident:
            out[nxt] = self._resident[nxt]
            nxt += 1
        pending = issue(nxt) if nxt < n else None
        while pending is not None:
            errs = self.read_handle.wait()
            check_io(errs, "param swap-in")
            idx, buf = pending
            ahead = idx + 1
            while ahead < n and ahead in self._resident:
                out[ahead] = self._resident[ahead]
                ahead += 1
            pending = issue(ahead) if ahead < n else None
            shape, dtype = self._meta[idx]
            out[idx] = buf.view(dtype).reshape(shape)
        return out  # type: ignore[return-value]

    def write_back(self, leaves: List[np.ndarray]) -> None:
        """Persist the updated leaves and keep the first ``window_bytes`` of
        them resident (the next fetch reads in leaf order)."""
        self._resident.clear()
        budget = self.window_bytes
        for i, leaf in enumerate(leaves):
            arr = np.ascontiguousarray(leaf)
            self._meta[i] = (arr.shape, arr.dtype)
            # the handle keeps the buffer alive until the wait below
            self.write_handle.pwrite(arr.reshape(-1).view(np.uint8), self._path(i))
            if budget >= arr.nbytes:
                self._resident[i] = arr
                budget -= arr.nbytes
        errs = self.write_handle.wait()
        check_io(errs, "param swap-out")

    def resident_bytes(self) -> int:
        return sum(a.nbytes for a in self._resident.values())

    def direct_fallbacks(self) -> int:
        return self.read_handle.direct_fallbacks() + self.write_handle.direct_fallbacks()

    def close(self) -> None:
        self.read_handle.close()
        self.write_handle.close()
