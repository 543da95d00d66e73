"""DeepSpeedEngine: the training engine (the subset of
``deepspeed_tpu/runtime/engine.py`` that one card runs).

The training loop upstream scripts write, and ``train_batch`` on top of it
(one code path, so both consume ``self.generator`` in the same order and
give the same bits; JAX ``engine.py:2376-2412``):

- ``forward(micro_batch)``: the micro-batch's training loss, with its graph;
- ``backward(loss=None)``: ``loss.backward()`` into the flat fp32 gradient
  buffer, zeroed at the first backward of each accumulation window;
  counts ``micro_steps``;
- ``step()``: a no-op until the window's last micro-batch
  (``is_gradient_accumulation_boundary``); there: divide by ``gas``,
  ``gnorm = global_norm_l2(grads)``, ``overflow = not isfinite(gnorm)``,
  clip by ``min(1, clip / (gnorm + 1e-6))`` when ``clip > 0``, and unless
  ``overflow`` the optimizer update (JAX ``engine.py:849-925, 1886-1934``).
  On overflow the parameters and the Adam count stay as they were; the
  step counter still advances;
- ``train_batch(batch)``: the global batch split into ``gas`` micro-batches
  through ``forward`` and ``backward``, then ``step``. Without a batch it
  reads the engine's training iterator (``initialize(training_data=...)``,
  ``deepspeed_io``).

Checkpoints (``save_checkpoint``, ``load_checkpoint``, ``resume``; JAX
``:2762-2790, 2809-2910, 2965-3081``) hold the fp32 parameters, the Adam
moments and count, the counters, ``client_state`` and the state of
``self.generator``: JAX folds its dropout and gating keys from the step
counters, the port draws them from that one stateful generator, so a resume
is bit-exact only with it. A load copies into the live parameters and
moments in place: the optimizer holds the parameter objects, and each
parameter's ``.grad`` is a view of the flat buffer. Verified loads fall back
to older intact tags (``runtime/resilience``). Under ``nebula.enabled`` a
save is async (JAX ``:2814-2924``): the call snapshots the state into
reused pinned host buffers on a side stream and returns; the next
``step()`` waits for that copy before the optimizer writes in place; a
background writer stages the tag, and ``flush_checkpoints`` (or the next
save, a load, ``resume``, or an exit hook at interpreter exit) publishes it
and its ``latest`` marker.

Resilience (JAX ``:291-300, 2477-2534, 2685-2775``), at the end of each
step's boundary: the overflow guard (``OverflowWatcher``:
``OverflowAbort`` at the ``resilience.max_consecutive_overflows``-th
skipped step in a row), the heartbeat of a supervised run
(``DS_ELASTIC_HEARTBEAT_FILE``, every ``heartbeat_interval`` seconds, with
``global_step``), the ``step`` fault point (``DS_FAULT_SPEC``), and the
preemption checkpoint: with ``resilience.preempt_save_dir`` (or
``enable_preemption_checkpoint``), a SIGTERM or SIGINT becomes a save at the
next boundary and ``SystemExit(preempt_exit_code)``; ``resume()`` defaults
to that directory.

An MoE model (``moe_num_experts > 0``) trains with training-mode gating
(``deterministic=False``, the train capacity factor and the gating noise)
even at dropout 0, as the JAX engine does; its load-balancing loss is part
of the training loss and not of ``eval_batch``'s. The config's ``"moe"``
block installs the default dispatch route for the engine's life (cleared
by an engine without one).

The model holds fp32 master parameters and computes in its config's
``dtype``, rounding each parameter to it where it is used (the JAX engine
casts the whole tree before ``apply``): bf16 under ``bf16``, fp16 under
``fp16``. Under fp16 the loss is multiplied by the live loss scale before
its backward, the step divides the gradients by ``gas * scale`` (JAX
``engine.py:915``), an overflow is ``has_overflow`` (any non-finite
gradient; without fp16 a non-finite norm), and after every step the scale
moves by ``create_loss_scaler``'s rule (``cur_scale``; JAX
``engine.py:1925``); the scaler's state travels in every checkpoint tag
(group ``loss_scale``), so a resume under fp16 is bit-exact. Under
``offload_optimizer`` the device divides before the gradients leave it and
an overflow skips the host update and cuts the scale (JAX
``engine.py:1166-1179``).

The optimizer is the config's type (``runtime/optimizers.py``: Adam,
AdamW, LAMB, Adagrad, SGD, Lion), or a client ``torch.optim.Optimizer`` over
the engine's parameters (``initialize(optimizer=...)``); its state goes into
every tag by parameter name. The ``program`` block (and the
``DS_REMAT_POLICY`` / ``DS_LMHEAD_CHUNK`` env layer) lands on the model's
config before anything else (JAX ``_apply_program_knobs``), and so does
the ``attention`` block's ``policy``, as ``attention_policy``;
``progressive_layer_drop`` anneals theta on the host and hands
``pld_theta`` to a model that takes it (JAX ``engine.py:365-386``);
``wall_clock_breakdown`` times ``train_batch`` (``utils/timer.py``).
``curriculum_learning`` with the ``seqlen`` metric truncates each
``train_batch``'s sequences to the scheduler's difficulty before anything
else (JAX ``engine.py:350-363, 2199-2201``), and its state travels in every
tag's metadata. ``quantize_training`` (MoQ, ``runtime/quantize.py``) fake-
quantizes the >= 2-D fp32 masters at the step's bit width in every training
forward and eval, with the straight-through estimator: each master's data
points at its quantized values from the forward until its backward has run
(so that a remat region's recompute reads them too, and the model's per-use
casts round them), and the gradient lands on the master; with
``eigenvalue`` enabled too, each layer's period is stretched
by its Hessian curvature, probed once before the first step on JAX's
synthetic batch (JAX ``engine.py:1641-1696, 1820-1840, 1981-1982``). MoQ
raises under either offload, where JAX applies it nowhere.
``compression_training`` through ``compression.init_compression`` (JAX
``engine.py:1440-1640, 1821-1864``) shares MoQ's window: every training
forward and eval reads the masters transformed at the step count
(quantized, pruned; MoQ after compression when both are on), and a
gradient hook on each compressed master multiplies what reaches it by the
window's pruning masks, which is the transform's derivative. Knowledge
distillation mixes the teacher's logits and block outputs into the
training loss inside its step window (``compression.compress
.distillation_loss``). Compression raises under either offload (JAX runs
offloaded steps uncompressed), distillation under ``offload_optimizer`` or
with the fused head, as in JAX. Batch keys besides ``input_ids`` and
``labels`` that the model's ``forward`` takes (``attention_mask``,
``token_type_ids``) go to it (JAX ``_module_kwargs``). The JAX engine ran the step as one
jitted program and ``train_batches`` as a ``lax.scan``; here they are
Python loops over eager PyTorch (a CUDA graph is later work). The
gradients live in one flat fp32 buffer, each parameter's ``.grad`` a view
of it, so the norm, the division and the clipping are one launch each.

ZeRO (JAX ``engine.py:1110-1354``; the ``zero_optimization`` block,
``runtime/zero/config.py``). On one card stages 1-3 partition nothing and
give stage 0's bits. Offload changes where state lives:

- ``offload_optimizer`` (``cpu`` or ``nvme``): no ``FusedAdam`` and no
  moment on the card. The engine keeps fp32 host masters (copies of the
  parameters, or the host-resting parameters themselves under
  ``offload_param``) and a host optimizer (``DeepSpeedCPUAdam``;
  ``NVMeAdam``, its moments swapped to ``<nvme_path>/optimizer``). The step
  keeps the device's ``/gas``, norm, clip and overflow skip, then fetches
  the flat fp32 gradients leaf by leaf into pinned staging on a copy
  stream (leaf i+1's copy overlaps leaf i's host update), runs
  ``step_single`` on each master and copies it back into its device
  parameter (no copy back when the parameters rest on the host: the
  master is the parameter). ``nvme`` fetches the whole buffer once and
  runs ``NVMeAdam.step``.
- ``offload_param`` (stage 3; ``cpu`` or ``nvme``): the parameters rest on
  the host as fp32 tensors and stream through the card block by block
  (``runtime/zero/param_offload.py``); the backward adds into the flat
  device gradient buffer. Without ``offload_optimizer`` the moments stay
  on the card and each leaf is copied in, updated and copied home
  (``FusedAdam.step_resting``). Under ``nvme`` every leaf is journaled to
  ``<nvme_path>/params`` after each step and released from the host but
  for ``max_in_cpu`` bytes; the next forward, eval, save or load brings
  them back.

A checkpoint under ``offload_optimizer`` holds the host optimizer's step
and moments in the ``host_optimizer`` group; the masters are the module
group's leaves bit for bit (the device parameters are fp32 copies of them)
and are rebuilt from it on load. A tag without that group (saved without
offload) loads its parameters and resets the host moments, with a warning
(JAX's rebuild rule).
"""

import dataclasses
import functools
import inspect
import logging
import os
import pickle
import tempfile
import threading
import time
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import WEIGHTS_NAME, save_npz
from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.elasticity.elastic_agent import touch_heartbeat
from deepspeed_tpu_torch.models.common import cross_entropy_loss
from deepspeed_tpu_torch.moe import routing as moe_routing
from deepspeed_tpu_torch.moe.sharded_moe import MOELayer
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_engine import (HOST_OPTIMIZER_GROUP,
                                                                        MODULE_GROUP,
                                                                        OPTIMIZER_GROUP,
                                                                        STATE_DIR,
                                                                        HostSnapshotPool,
                                                                        TorchCheckpointEngine)
from deepspeed_tpu_torch.runtime.config import (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, DeepSpeedConfig,
                                                comm_dtype, program_env_updates)
from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (LossScaleState, OverflowWatcher,
                                                          create_loss_scaler, has_overflow)
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.resilience.faults import fault_point
from deepspeed_tpu_torch.runtime.resilience.manifest import (CheckpointCorruptError,
                                                             list_checkpoint_tags,
                                                             sweep_stale_staging,
                                                             write_atomic_text)
from deepspeed_tpu_torch.runtime.resilience.signals import PreemptionGuard
from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import NVMeAdam
from deepspeed_tpu_torch.runtime.utils import global_norm_l2
from deepspeed_tpu_torch.runtime.zero.param_offload import (ParamStreamer, PartitionedParamSwapper,
                                                            param_streaming, stream_top)
from deepspeed_tpu_torch.utils.timer import TRAIN_BATCH_TIMER, NoopTimer, SynchronizedWallClockTimer

logger = logging.getLogger(__name__)

LATEST_NAME = "latest"
#: where the nvme tiers swap when ``nvme_path`` is not set
DEFAULT_NVME_DIR = "ds_tpu_torch_nvme"
#: the checkpoint leaf of ``self.generator``'s state
RNG_KEY = "rng/generator"
#: the checkpoint group of the fp16 loss scaler's state
LOSS_SCALE_GROUP = "loss_scale"
#: the optimizer group's prefix of a client optimizer's state tensors
CLIENT_PREFIX = "client"


def _apply_program_knobs(module, program_config, attention_policy: Optional[str] = None) -> None:
    """Put the ``program`` block's knobs, the ``attention`` block's
    ``policy`` (as ``attention_policy``) and the ``DS_REMAT_POLICY`` /
    ``DS_LMHEAD_CHUNK`` env layer (env wins) onto ``module``'s config (JAX
    ``_apply_program_knobs``, ``engine.py:114-152``): a block knob the
    family's config does not declare raises, an env knob warns. The port's
    modules hold their config, so the replaced config is set on every
    submodule that held the old one. Per engine: JAX installs the attention
    block for the whole process, the port keeps it on the model."""
    cfg_updates = program_config.model_updates()
    if attention_policy is not None:
        cfg_updates["attention_policy"] = attention_policy
    env_updates = program_env_updates()
    if not cfg_updates and not env_updates:
        return
    mcfg = getattr(module, "config", None)
    if mcfg is None or not dataclasses.is_dataclass(mcfg):
        if cfg_updates:
            raise ValueError(f"'program' or 'attention' config block set but "
                             f"{type(module).__name__} carries no dataclass model config to apply "
                             f"it to")
        logger.warning("program env override (%s) ignored: %s has no model config",
                       sorted(env_updates), type(module).__name__)
        return
    missing = sorted(f for f in cfg_updates if not hasattr(mcfg, f))
    if missing:
        raise ValueError(f"the config's 'program' or 'attention' block sets {missing} but "
                         f"{type(mcfg).__name__} does not declare those fields — the knob would "
                         f"silently not apply")
    for f in sorted(set(env_updates) - set(mcfg.__dataclass_fields__)):
        logger.warning("program env override %s ignored: %s does not declare it",
                       f, type(mcfg).__name__)
        env_updates.pop(f)
    changed = {f: v for f, v in {**cfg_updates, **env_updates}.items() if getattr(mcfg, f) != v}
    if not changed:
        return
    new = dataclasses.replace(mcfg, **changed)
    for sub in module.modules():
        for attr in ("config", "cfg"):
            if getattr(sub, attr, None) is mcfg:
                object.__setattr__(sub, attr, new)


def default_causal_lm_loss(outputs, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy of logits over ``labels`` (default:
    ``input_ids``). An MoE model's ``(logits, aux_loss)`` adds the
    (already scaled) load-balancing loss."""
    labels = batch.get("labels", batch["input_ids"])
    logits, aux_loss = outputs if isinstance(outputs, (tuple, list)) else (outputs, 0.0)
    return cross_entropy_loss(logits[:, :-1], labels[:, 1:]) + aux_loss


def _truncate_seq(batch, seqlen: int):
    """Every ``[batch, seq, ...]`` array or tensor of ``batch`` (a dict, or
    the ``input_ids`` alone) cut to ``seqlen`` tokens (curriculum learning,
    the seqlen metric; JAX ``engine.py:78-86``)."""
    def trunc(x):
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if x.ndim >= 2 and x.shape[1] > seqlen:
            x = x[:, :seqlen]
            return x.contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)
        return x
    if isinstance(batch, dict):
        return {k: trunc(v) for k, v in batch.items()}
    return trunc(batch)


def _masked_grad(masks: Dict[str, Optional[torch.Tensor]], name: str, grad: torch.Tensor):
    """A compressed parameter's gradient times its live pruning mask."""
    mask = masks.get(name)
    return grad if mask is None else grad * mask


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} belongs to a later slice of the PyTorch port "
                               f"(ROADMAP.md Queue A item {item})")


class DeepSpeedEngine:

    def __init__(self, model, config: DeepSpeedConfig, loss_fn: Optional[Callable] = None,
                 lr_scheduler: Optional[Callable[[int], float]] = None, device: DeviceLike = None,
                 training_data=None, collate_fn: Optional[Callable] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None):
        self.device = resolve_device(device)
        _apply_program_knobs(model, config.program_config, config.attention_config.policy)
        mcfg = model.config
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device} but the engine runs on "
                             f"{self.device}; build the model with device={str(self.device)!r}")
        cfg_name = type(mcfg).__name__
        if mcfg.param_dtype != torch.float32 or getattr(mcfg, "serve_weight_dtype", None) is not None:
            raise ValueError(f"training needs fp32 master parameters ({cfg_name}.param_dtype="
                             "torch.float32, no serve_weight_dtype)")
        if config.bfloat16_enabled and mcfg.dtype != torch.bfloat16:
            raise ValueError("bf16 is enabled but the model computes in "
                             f"{mcfg.dtype}; build it with {cfg_name}.dtype=torch.bfloat16")
        if config.fp16_enabled and mcfg.dtype != torch.float16:
            raise ValueError("fp16 is enabled but the model computes in "
                             f"{mcfg.dtype}; build it with {cfg_name}.dtype=torch.float16")
        self.module = model
        self.config = config
        self.client_optimizer = optimizer
        moe_routing.set_default_route(config.moe_route, config.moe_kernel)
        # the loss scaler (JAX ``engine.py:241-246``): static 1.0 without fp16
        if config.fp16_enabled:
            self._ls_state, self._ls_update = create_loss_scaler(
                static_loss_scale=config.loss_scale, **config.dynamic_loss_scale_args)
        else:
            self._ls_state, self._ls_update = create_loss_scaler(static_loss_scale=1.0)
        self.timers = (SynchronizedWallClockTimer(self.device) if config.wall_clock_breakdown
                       else NoopTimer())
        #: the overflow watcher's monitor events, in order (JAX buffers them
        #: for its monitor)
        self.overflow_events: list = []
        self.progressive_layer_drop = None
        self._pld_model = False
        self._forward_args = set(inspect.signature(type(model).forward).parameters)
        if config.pld_enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(**config.pld_params)
            accepts = "pld_theta" in self._forward_args
            flag_on = bool(getattr(mcfg, "progressive_layer_drop", False))
            self._pld_model = accepts and flag_on
            if not self._pld_model:
                logger.warning("progressive_layer_drop enabled but the model will not drop layers "
                               "(model accepts pld_theta: %s, model config progressive_layer_drop "
                               "flag: %s) — set progressive_layer_drop=True on a supporting model "
                               "config, e.g. GPT2Config; theta will anneal but no layers will drop",
                               accepts, flag_on)
        self.loss_fn = loss_fn or default_causal_lm_loss
        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is None and config.scheduler_name is not None:
            self.lr_scheduler = get_lr_schedule(config.scheduler_name, config.scheduler_params)
        zcfg = config.zero_config
        self._param_offload = zcfg.offload_param_device != "none"
        self._host_opt = None
        self._host_masters = None
        self._streamer: Optional[ParamStreamer] = None
        self._param_swapper: Optional[PartitionedParamSwapper] = None
        self._params_released = False
        self._staging = None
        self._copy_stream = None
        #: the last offloaded step's host-side parts (seconds and bytes)
        self.offload_timings: dict = {}
        # curriculum learning (JAX ``engine.py:350-363``): for the seqlen
        # metric the engine truncates each batch itself
        cl_cfg = config.curriculum_learning_legacy
        self.curriculum_scheduler = None
        self.curriculum_metric = None
        if cl_cfg.get("enabled", False):
            self.curriculum_scheduler = CurriculumScheduler(cl_cfg)
            self.curriculum_metric = cl_cfg.get("curriculum_type", "seqlen")
            logger.info(f"curriculum learning enabled: metric={self.curriculum_metric} "
                        f"schedule={cl_cfg.get('schedule_type')}")
        # MoQ: resolved against the parameters before the first forward
        self._moq = None
        self._moq_params: Dict[str, torch.Tensor] = {}
        # the masters' own data while the swap window holds their
        # transformed values (MoQ's and compression's)
        self._moq_masters: Optional[Dict[str, torch.Tensor]] = None
        # compression training (``compression.init_compression``): the
        # resolved spec, its parameters, the live window's pruning masks
        # (which the gradient hooks read), and knowledge distillation
        self._compression = None
        self._comp_params: Dict[str, torch.Tensor] = {}
        self._grad_masks: Dict[str, Optional[torch.Tensor]] = {}
        self._comp_hooks: list = []
        self._kd_config: Optional[dict] = None
        self.moq_period_factors: Optional[Dict[str, float]] = None
        self._moq_pending = bool(config.quantize_training_config.get("enabled", False))
        if self._moq_pending and (self._param_offload or zcfg.offload_optimizer_device != "none"):
            # JAX raises under offload_param and runs offloaded steps
            # unquantized (engine.py:1848-1862)
            raise ValueError("quantize_training (MoQ) does not compose with offload_param or "
                             "offload_optimizer: the JAX engine applies it on neither path; "
                             "disable one of the two")
        if self._param_offload:
            self._rest_params_on_host()
        self.optimizer = self._configure_optimizer()
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._grads: Optional[torch.Tensor] = None
        self._grad_slices: Dict[str, slice] = {}
        self._last_grad_norm: Optional[torch.Tensor] = None
        self._pending_loss: Optional[torch.Tensor] = None
        self._window_open = False  # a backward ran since the last step
        self._retain_grads = False
        self._retained_grads: Optional[torch.Tensor] = None
        self.training_dataloader = (self.deepspeed_io(training_data, collate_fn=collate_fn)
                                    if training_data is not None else None)
        self._train_iter = None
        self.loaded_checkpoint_tag: Optional[str] = None
        # async saves: the pending one, its snapshot's event, the reused
        # host buffers and whether the exit hook is registered
        self._pending_ckpt = None
        self._snapshot_ready = None
        self._snapshot_pool: Optional[HostSnapshotPool] = None
        self._flush_at_exit = False
        # resilience (JAX ``engine.py:291-300``)
        rcfg = config.resilience_config
        self._overflow_watcher = OverflowWatcher(abort_after=rcfg.max_consecutive_overflows)
        self._preemption: Optional[PreemptionGuard] = None
        self._preempt_save_dir: Optional[str] = None
        self._preempt_exit = rcfg.exit_after_preempt_save
        self._preempt_exit_code = rcfg.preempt_exit_code
        if rcfg.preempt_save_dir:
            self.enable_preemption_checkpoint(rcfg.preempt_save_dir)

    def _configure_optimizer(self):
        """The client optimizer; or the config's type over the parameters
        (``FusedAdam`` by default, its moments on the card, also under
        ``offload_param``); or under ``offload_optimizer`` the host
        optimizer, with no moment on the card. The host path runs Adam only:
        where JAX swaps Adam in for another type, the port refuses it."""
        name = self.config.optimizer_name or ADAM_OPTIMIZER
        offload = self.config.zero_config.offload_optimizer_device != "none"
        if offload or self._param_offload:
            if self.client_optimizer is not None:
                raise NotImplementedError("a client optimizer under ZeRO offload: the offloaded "
                                          "step runs the port's own Adam on the host-resting or "
                                          "host-mastered parameters")
            if name not in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
                where = "offload_optimizer" if offload else "offload_param"
                raise NotImplementedError(f"optimizer {name!r} under {where}: the offloaded step "
                                          f"runs Adam (JAX runs its host Adam in place of "
                                          f"{name!r} without a word; the PyTorch port refuses)")
        if offload:
            return self._setup_offload_optimizer()
        if self.client_optimizer is not None:
            own = {id(p) for p in self.module.parameters()}
            theirs = [p for g in self.client_optimizer.param_groups for p in g["params"]]
            if any(id(p) not in own for p in theirs):
                raise ValueError("the client optimizer must hold the engine's model parameters")
            return self.client_optimizer
        return build_optimizer(name, self.module.parameters(), self.config.optimizer_params or {},
                               lr_schedule=self.lr_scheduler,
                               state_device=self.device if self._param_offload else None)

    # -- ZeRO offload (JAX ``engine.py:1110-1354``) ------------------------------
    def _nvme_dir(self, block, leaf: str) -> str:
        base = block.nvme_path or os.path.join(tempfile.gettempdir(), DEFAULT_NVME_DIR)
        return os.path.join(str(base), leaf)

    def _rest_params_on_host(self) -> None:
        """Move every parameter to its host resting place (fp32, pinned when
        ``offload_param.pin_memory``), and under ``nvme`` journal it to
        ``<nvme_path>/params`` (JAX ``_setup_param_offload``)."""
        poff = self.config.zero_config.offload_param
        pin = poff.pin_memory and self.device.type == "cuda"
        with torch.no_grad():
            for p in self.module.parameters():
                if p.device.type != "cpu" or pin:
                    host = torch.empty(p.shape, dtype=p.dtype, pin_memory=pin)
                    host.copy_(p)
                    p.data = host
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        n_bytes = sum(p.numel() * p.element_size() for p in self.module.parameters())
        if poff.device == "nvme":
            self._param_swapper = PartitionedParamSwapper(
                self._nvme_dir(poff, "params"), window_bytes=poff.max_in_cpu,
                n_threads=max(poff.buffer_count, 1))
            self._param_swapper.initialize([p.detach().numpy() for p in self.module.parameters()])
        logger.info(f"parameter offload enabled: device={poff.device} ({n_bytes / 1e6:.1f} MB "
                    f"resting off the card{', pinned' if pin else ''})")

    def _setup_offload_optimizer(self):
        """The host optimizer and its fp32 masters (JAX
        ``_setup_offload_optimizer``, single process)."""
        off = self.config.zero_config.offload_optimizer
        params = dict(self.config.optimizer_params or {})
        kwargs = dict(lr=params.get("lr", 1e-3), betas=tuple(params.get("betas", (0.9, 0.999))),
                      eps=params.get("eps", 1e-8), weight_decay=params.get("weight_decay", 0.0),
                      adamw_mode=params.get("adam_w_mode",
                                            self.config.optimizer_name == ADAMW_OPTIMIZER))
        named = list(self.module.named_parameters())
        if off.device == "cpu":
            opt = DeepSpeedCPUAdam(bias_correction=params.get("bias_correction", True), **kwargs)
            for i, (_, p) in enumerate(named):
                opt.ensure_state(i, p.numel())
        elif off.device == "nvme":
            opt = NVMeAdam(swap_dir=self._nvme_dir(off, "optimizer"), **kwargs)
        else:
            raise ValueError(f"unknown offload_optimizer.device {off.device!r}")
        self._host_opt = opt
        if self._param_offload:
            # the host-resting parameters are the masters: the update lands
            # in their resting place with no trip through the card
            self._host_masters = [p for _, p in named]
        else:
            pin = off.pin_memory and self.device.type == "cuda"
            with torch.no_grad():
                self._host_masters = [torch.empty(p.shape, dtype=torch.float32,
                                                  pin_memory=pin).copy_(p) for _, p in named]
        logger.info(f"optimizer offload enabled: device={off.device} "
                    f"({sum(p.numel() for _, p in named) / 1e6:.1f}M host master elems)")
        return opt

    # ------------------------------------------------------------------
    def initialize_state(self, example_batch=None) -> None:
        """Allocate the flat fp32 gradient buffer and point every
        parameter's ``.grad`` into it (the optimizer moments exist since
        ``initialize``). Idempotent; ``forward`` calls it."""
        if self._grads is not None:
            return
        named = list(self.module.named_parameters())
        self._grads = torch.zeros(sum(p.numel() for _, p in named), dtype=torch.float32,
                                  device=self.device)
        offset = 0
        views = {}
        for name, p in named:
            self._grad_slices[name] = slice(offset, offset + p.numel())
            view = self._grads[self._grad_slices[name]].view(p.shape)
            if self._param_offload:
                # a host-resting parameter takes no device .grad: the
                # streaming backward adds into its view
                views[id(p)] = view
            else:
                p.grad = view
            offset += p.numel()
        if self._param_offload:
            self._streamer = ParamStreamer(self.device, self.module.config.dtype, views)

    def _stage(self, batch) -> dict:
        if not isinstance(batch, dict):
            batch = {"input_ids": batch}
        return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def _resolve_moq(self) -> None:
        """Build the MoQ transform once, before the first forward or eval
        (JAX resolves it when the state first exists), with the eigenvalue
        period factors when that block is enabled."""
        if not self._moq_pending:
            return
        from deepspeed_tpu_torch.runtime.quantize import build_moq_transform
        self._moq_pending = False
        named = dict(self.module.named_parameters())
        #: the eigenvalue block's period factor by layer (None without it)
        self.moq_period_factors = self._moq_eigenvalue_factors()
        self._moq = build_moq_transform(named, self.config.quantize_training_config,
                                        period_factors=self.moq_period_factors)
        if self._moq is not None:
            self._moq_params = {n: named[n] for n in self._moq.names}

    def _moq_swap_in(self) -> None:
        """Point each transformed master's data at its values at this step:
        compression's, then MoQ's on top (JAX's ``moq(comp(p, s), s)``,
        ``engine.py:1831-1836``). The forward and any recompute read them
        and the gradient lands on the master: straight through a
        quantization (JAX's ``x + stop_gradient(q - x)``), times the
        active pruning masks, which the gradient hooks apply."""
        if (self._moq is None and self._compression is None) or self._moq_masters is not None:
            return
        values: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            if self._compression is not None:
                values, masks = self._compression.apply(self._comp_params, self.global_steps,
                                                        grad_masks=True)
                self._grad_masks.update(masks)
            if self._moq is not None:
                values.update(self._moq({n: values.get(n, p) for n, p in self._moq_params.items()},
                                        self.global_steps))
        params = {**self._comp_params, **self._moq_params}
        self._moq_masters = {n: params[n].data for n in values}
        for n, v in values.items():
            params[n].data = v

    def _moq_swap_out(self) -> None:
        """Point the masters' data back at the fp32 masters."""
        if self._moq_masters is None:
            return
        params = {**self._comp_params, **self._moq_params}
        for n, data in self._moq_masters.items():
            params[n].data = data
        self._moq_masters = None
        self._grad_masks.clear()

    def _install_compression(self, spec) -> None:
        """Apply ``spec`` (a ``compression.CompressionSpec``, or None to
        remove it) from the next forward on: its parameters join the swap
        window, and a gradient hook on each multiplies what reaches it by
        the window's pruning mask."""
        for handle in self._comp_hooks:
            handle.remove()
        self._compression, self._comp_hooks = spec, []
        named = dict(self.module.named_parameters())
        self._comp_params = {n: named[n] for n in (spec.rules if spec is not None else ())}
        for name, p in self._comp_params.items():
            self._comp_hooks.append(p.register_hook(functools.partial(_masked_grad, self._grad_masks,
                                                                      name)))

    def _moq_refuse_pending(self, what: str) -> None:
        """Raise while a ``forward`` waits for its ``backward``: the masters'
        data are the quantized values until then."""
        if self._moq_masters is not None:
            raise RuntimeError(f"{what} between forward() and backward() under quantize_training "
                               f"or compression_training: the masters hold their transformed "
                               f"values until backward() ends")

    def _moq_eigenvalue_factors(self) -> Optional[Dict[str, float]]:
        """Eigenvalue-modulated MoQ periods (JAX ``engine.py:1641-1696``):
        each layer's top Hessian eigenvalue, probed once on a synthetic
        batch (numpy seed 0, ``[micro, min(positions, 128)]`` tokens, eval
        loss), becomes the period factor ``1 + floor(eig / max_eig * 4)``.
        None unless the ``eigenvalue`` block is enabled. The HVP is taken
        with respect to the module's own parameters, so that a remat
        region's recompute differentiates the same tensors. A loss that
        cannot be differentiated twice (the flash kernels) raises, as JAX's
        HVP through its Pallas kernels does."""
        ev_cfg = self.config.eigenvalue_config
        if not ev_cfg.get("enabled", False):
            return None
        import math

        from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue

        mcfg = self.module.config
        layer_name = ev_cfg.get("layer_name", "h")
        layer_num = int(ev_cfg.get("layer_num", getattr(mcfg, "n_layer",
                                                        getattr(mcfg, "num_hidden_layers", 0))))
        if not layer_name or layer_num <= 0:
            logger.warning("eigenvalue enabled but layer_name/layer_num resolve to "
                           f"{layer_name!r}/{layer_num}; skipping MoQ period modulation")
            return None
        seq = min(int(getattr(mcfg, "n_positions", getattr(mcfg, "max_position_embeddings", 128))),
                  128)
        vocab = int(getattr(mcfg, "vocab_size", 256))
        rng = np.random.default_rng(0)
        probe = self._stage({"input_ids": rng.integers(
            0, vocab, (self.config.train_micro_batch_size_per_gpu, seq)).astype(np.int32)})
        ev = Eigenvalue(verbose=bool(ev_cfg.get("verbose", False)),
                        max_iter=int(ev_cfg.get("max_iter", 10)), tol=float(ev_cfg.get("tol", 1e-2)),
                        stability=float(ev_cfg.get("stability", 1e-6)), layer_name=layer_name,
                        layer_num=layer_num)
        params = dict(self.module.named_parameters())
        try:
            with torch.enable_grad():
                # raw values: a diverged layer skips the modulation
                eigs = ev.compute_eigenvalue(lambda p: self._loss_for(probe, train=False),
                                             params, generator=torch.Generator(
                                                 device=self.device).manual_seed(0), scrub=False)
        except KeyError as e:
            logger.warning(f"eigenvalue: {e}; skipping MoQ period modulation")
            return None
        if not all(math.isfinite(e) for e in eigs):
            logger.warning("eigenvalue returned non-finite values; skipping MoQ period modulation")
            return None
        max_eig = max(eigs) or 1.0
        factors = {f"{layer_name}_{i}": 1.0 + math.floor(e / max_eig * 4) for i, e in enumerate(eigs)}
        logger.info(f"MoQ eigenvalue period factors: {factors}")
        return factors

    def _module_kwargs(self, mb: dict) -> dict:
        """The batch keys besides ``input_ids`` and ``labels`` that the
        module's ``forward`` takes (``attention_mask``, ``token_type_ids``;
        JAX ``engine.py:1365-1375``)."""
        return {k: v for k, v in mb.items()
                if k not in ("input_ids", "labels") and k in self._forward_args}

    def _loss_for(self, mb: dict, train: bool) -> torch.Tensor:
        mcfg = self.module.config
        ids = mb["input_ids"]
        moe = getattr(mcfg, "moe_num_experts", 0) > 0
        # a family without dropout (LLaMA) has no ``dropout`` field
        stochastic = train and (getattr(mcfg, "dropout", 0.0) > 0.0 or moe)
        kwargs = dict(self._module_kwargs(mb), deterministic=not stochastic,
                      generator=self.generator if stochastic else None)
        # a fused-head model computes the loss itself (no [B, L, V] logits);
        # only the default loss knows that contract
        fused_head = (self.loss_fn is default_causal_lm_loss
                      and getattr(mcfg, "fused_head_loss_chunk", 0) > 0)
        if fused_head:
            kwargs["labels"] = mb.get("labels", ids)
        if train and self._pld_model:
            kwargs.update(deterministic=False, generator=self.generator,
                          pld_theta=self.progressive_layer_drop.get_theta())
        kd = self._kd_config if train else None
        if kd is not None and fused_head:
            raise ValueError("knowledge_distillation needs student logits; fused_head_loss_chunk "
                             "never materializes them — disable one of the two")
        if kd is not None and kd["schedule_offset"] <= self.global_steps < kd["schedule_offset_end"]:
            from deepspeed_tpu_torch.compression.compress import distillation_loss
            return distillation_loss(self, kd, mb, kwargs)
        outputs = self._run_module(ids, **kwargs)
        if not train and moe and isinstance(outputs, (tuple, list)):
            # eval reports the pure cross-entropy: the load-balancing loss
            # regularizes training only
            outputs = outputs[0]
        return outputs if fused_head else self.loss_fn(outputs, mb)

    def _run_module(self, ids, **kwargs):
        """The model's forward; under ``offload_param`` its leaves outside
        the blocks streamed here and the blocks' inside their regions."""
        if not self._param_offload:
            return self.module(ids, **kwargs)
        self.initialize_state()
        self._ensure_params_resident()
        with param_streaming(self._streamer):
            return torch.func.functional_call(self.module, stream_top(self.module, self._streamer),
                                              (ids,), kwargs)

    # -- the training loop -------------------------------------------------
    def forward(self, batch) -> torch.Tensor:
        """The training loss of one micro-batch (a dict of ``[micro, ...]``
        arrays or tensors, or the ``input_ids`` alone), with its graph;
        ``backward`` consumes it. Dropout and MoE gating draw from
        ``self.generator``."""
        self.initialize_state()
        self._resolve_moq()
        self._moq_swap_in()  # out again after this loss's backward
        try:
            self._pending_loss = self._loss_for(self._stage(batch), train=True)
        except BaseException:
            self._moq_swap_out()
            raise
        if not self._pending_loss.requires_grad:
            self._moq_swap_out()  # no backward follows a loss without a graph
        return self._pending_loss

    def backward(self, loss: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Accumulate ``loss``'s gradients (default: the last ``forward``'s
        loss) into the flat fp32 buffer, zeroed at the first backward of an
        accumulation window. Raises ``RuntimeError`` without a ``forward``
        before it."""
        if self._pending_loss is None:
            raise RuntimeError("backward() must follow forward()")
        loss = self._pending_loss if loss is None else loss
        self._pending_loss = None
        if not self._window_open:
            self._grads.zero_()
            self._window_open = True
        try:
            if self.config.fp16_enabled:
                (loss * torch.tensor(self._ls_state.loss_scale, dtype=torch.float32,
                                     device=loss.device)).backward()
            else:
                loss.backward()
        finally:
            self._moq_swap_out()
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.config.gradient_accumulation_steps == 0

    def step(self) -> None:
        """The optimizer step at the end of an accumulation window; a no-op
        before it (and without a backward since the last step)."""
        if not (self._window_open and self.is_gradient_accumulation_boundary()):
            return
        cfg = self.config
        grads = self._grads
        gas = cfg.gradient_accumulation_steps
        if cfg.fp16_enabled:
            # one fp32 divisor, gas * scale, as JAX divides
            grads.div_(float(torch.tensor(gas, dtype=torch.float32)
                             * torch.tensor(self._ls_state.loss_scale, dtype=torch.float32)))
        else:
            grads.div_(gas)
        if self._retain_grads:
            self._retained_grads = grads.clone()
        gnorm = global_norm_l2([grads])
        overflow = has_overflow([grads]) if cfg.fp16_enabled else not bool(torch.isfinite(gnorm))
        if cfg.gradient_clipping > 0:
            grads.mul_(torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0))
        self._ls_state = self._ls_update(self._ls_state, overflow)
        if overflow:
            self.skipped_steps += 1
            logger.info(f"step {self.global_steps} overflow: skipped update"
                        + (f", loss scale -> {self.cur_scale}" if cfg.fp16_enabled else ""))
        else:
            self._await_snapshot()
            if self._host_opt is not None:
                self._offload_step()
            elif self._param_offload:
                self.optimizer.step_resting(self._streamer.grad_views, self.device)
            else:
                self.optimizer.step()
        self._journal_params_to_nvme()
        self._last_grad_norm = gnorm
        self._window_open = False
        self.global_steps += 1
        self.global_samples += cfg.train_batch_size
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        self._after_boundary(overflow)

    def _offload_step(self) -> None:
        """The host update of every master (JAX ``_offload_train_batch``,
        single process): ``step_single`` leaf by leaf, each leaf's gradient
        fetched into pinned staging on a copy stream while the previous
        leaf is updated, each updated master copied into its device
        parameter unless the parameters rest on the host. ``NVMeAdam``
        takes the whole host gradient at once. Records
        ``offload_timings``."""
        opt, masters = self._host_opt, self._host_masters
        slices = list(self._grad_slices.values())
        cuda = self.device.type == "cuda"
        t = {"d2h_wait_s": 0.0, "host_adam_s": 0.0, "h2d_s": 0.0, "d2h_ms": 0.0,
             "d2h_bytes": self._grads.numel() * 4, "h2d_bytes": 0}
        lr = self.get_lr()[0]
        if isinstance(opt, NVMeAdam):
            t0 = time.perf_counter()
            host = self._grads.to("cpu")
            t["d2h_wait_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            opt.step(masters, [host[sl] for sl in slices], lr=lr)
            t["host_adam_s"] = time.perf_counter() - t0
        elif not cuda:
            opt.begin_step(lr=lr)
            t0 = time.perf_counter()
            for i, (m, sl) in enumerate(zip(masters, slices)):
                opt.step_single(i, m, self._grads[sl])
            t["host_adam_s"] = time.perf_counter() - t0
        else:
            largest = max(sl.stop - sl.start for sl in slices)
            if self._staging is None or self._staging[0].numel() < largest:
                self._staging = [torch.empty(largest, dtype=torch.float32, pin_memory=True)
                                 for _ in range(2)]
                self._copy_stream = torch.cuda.Stream(self.device)
            stream = self._copy_stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
            events = []

            def fetch(sl, buf):
                with torch.cuda.stream(stream):
                    start = torch.cuda.Event(enable_timing=True)
                    done = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                    buf[:sl.stop - sl.start].copy_(self._grads[sl], non_blocking=True)
                    done.record(stream)
                events.append((start, done))
                return done

            opt.begin_step(lr=lr)
            cur, nxt = self._staging
            done = fetch(slices[0], cur)
            for i, (m, sl) in enumerate(zip(masters, slices)):
                t0 = time.perf_counter()
                done.synchronize()
                t1 = time.perf_counter()
                t["d2h_wait_s"] += t1 - t0
                if i + 1 < len(slices):
                    done = fetch(slices[i + 1], nxt)
                opt.step_single(i, m, cur[:sl.stop - sl.start])
                t2 = time.perf_counter()
                t["host_adam_s"] += t2 - t1
                cur, nxt = nxt, cur
            t["d2h_ms"] = sum(a.elapsed_time(b) for a, b in events)
        if not self._param_offload:
            t0 = time.perf_counter()
            with torch.no_grad():
                for p, m in zip(self.module.parameters(), masters):
                    p.copy_(m.view(p.shape), non_blocking=m.is_pinned())
                    t["h2d_bytes"] += m.numel() * 4
            if cuda:
                torch.cuda.current_stream(self.device).synchronize()
            t["h2d_s"] = time.perf_counter() - t0
        self.offload_timings = t

    def _journal_params_to_nvme(self) -> None:
        """Under ``offload_param.device: nvme``: persist every leaf to its
        swap file and release it from the host but for the swapper's
        ``max_in_cpu`` window (JAX ``_journal_params_to_nvme``)."""
        if self._param_swapper is None:
            return
        params = list(self.module.parameters())
        self._param_swapper.write_back([p.detach().numpy() for p in params])
        empty = torch.empty(0, dtype=torch.float32)
        for p in params:
            p.data = empty
        self._params_released = True

    def _ensure_params_resident(self) -> None:
        """Bring released parameters back from the journal (window leaves
        from RAM, the rest read pipelined; JAX ``_ensure_params_resident``)."""
        if not self._params_released:
            return
        for p, arr in zip(self.module.parameters(), self._param_swapper.fetch_all()):
            p.data = torch.from_numpy(arr)
        self._params_released = False

    @property
    def params_released(self) -> bool:
        """True between steps under ``offload_param.device: nvme``: the host
        holds only the swapper's window."""
        return self._params_released

    def _after_boundary(self, overflow: bool) -> None:
        """The end of a step's boundary, in JAX's order (``engine.py:2477-2534``):
        the heartbeat, the overflow guard, the ``step`` fault point, then
        the preemption checkpoint."""
        touch_heartbeat(min_interval=self.config.resilience_config.heartbeat_interval,
                        payload={"global_step": self.global_steps,
                                 # the training telemetry is not ported yet
                                 "last_span": None, "world_size": 1, "mesh_axes": None})
        self.overflow_events += self._overflow_watcher.record(self.global_steps, overflow,
                                                              self.cur_scale)
        fault_point("step", step=self.global_steps)
        self._maybe_preempt_checkpoint()

    def _await_snapshot(self) -> None:
        """Make the current stream wait for a pending async snapshot's
        copies before anything writes the parameters or moments in place."""
        if self._snapshot_ready is not None:
            torch.cuda.current_stream(self.device).wait_event(self._snapshot_ready)
            self._snapshot_ready = None

    def train_batch(self, batch=None, data_iter=None) -> torch.Tensor:
        """One optimization step over a global batch (dict of [batch, ...]
        arrays or tensors, or the ``input_ids`` alone), by default the next
        of ``data_iter`` or of the engine's training iterator. Returns the
        mean micro-batch loss (fp32 scalar on the device)."""
        if self._window_open or not self.is_gradient_accumulation_boundary():
            raise RuntimeError(f"train_batch inside an open accumulation window (micro_steps "
                               f"{self.micro_steps}, gas {self.config.gradient_accumulation_steps}): "
                               f"finish the window with backward() and step() first")
        if batch is None:
            it = data_iter if data_iter is not None else self._training_iterator()
            if it is None:
                raise ValueError("train_batch needs a batch, a data_iter or initialize(training_data=...)")
            batch = next(it)
        if self.curriculum_scheduler is not None and self.curriculum_metric == "seqlen":
            seqlen = self.curriculum_scheduler.update_difficulty(self.global_steps + 1)
            batch = _truncate_seq(batch, seqlen)
        cfg = self.config
        gas = cfg.gradient_accumulation_steps
        self.timers(TRAIN_BATCH_TIMER).start()
        staged = self._stage(batch)
        n = staged["input_ids"].shape[0]
        if n != cfg.train_batch_size:
            raise ValueError(f"train_batch got {n} samples; train_batch_size is "
                             f"{cfg.train_batch_size}")
        micro = {k: v.reshape((gas, n // gas) + tuple(v.shape[1:])) for k, v in staged.items()}
        losses = []
        for i in range(gas):
            losses.append(self.forward({k: v[i] for k, v in micro.items()}).detach().float())
            self.backward()
        self.step()
        self.timers(TRAIN_BATCH_TIMER).stop()
        if cfg.wall_clock_breakdown and self.global_steps % cfg.steps_per_print == 0:
            self.timers.log([TRAIN_BATCH_TIMER], memory_breakdown=cfg.memory_breakdown)
        return torch.stack(losses).mean()

    def train_batches(self, batch_stack) -> torch.Tensor:
        """``train_batch`` over each step of stacked ``[n_steps,
        global_batch, ...]`` leaves; returns the losses ``[n_steps]``."""
        if not isinstance(batch_stack, dict):
            batch_stack = {"input_ids": batch_stack}
        n_steps = len(next(iter(batch_stack.values())))
        return torch.stack([self.train_batch({k: v[i] for k, v in batch_stack.items()})
                            for i in range(n_steps)])

    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        """The loss of the whole batch, deterministic (no dropout); under
        MoQ, of the quantized model that training optimizes (between a
        ``forward`` and its ``backward`` the swap stays that forward's)."""
        self._resolve_moq()
        pending = self._moq_masters is not None
        self._moq_swap_in()
        try:
            return self._loss_for(self._stage(batch), train=False)
        finally:
            if not pending:
                self._moq_swap_out()

    def load_optimizer_state(self, state: dict) -> None:
        """Load an optimizer state keyed by parameter name (e.g.
        ``checkpoint.from_jax.opt_state_from_jax``), into ``FusedAdam`` or
        the host optimizer."""
        self._await_snapshot()
        named = dict(self.module.named_parameters())
        if self._host_opt is None:
            self.optimizer.load_named_state(named, state)
            return
        for key in ("exp_avg", "exp_avg_sq"):
            if set(state[key]) != set(named):
                raise KeyError(f"optimizer state {key}: the names differ from the model's")
        flat = {str(i): {"m": torch.as_tensor(state["exp_avg"][k]).reshape(-1).float().numpy(),
                         "v": torch.as_tensor(state["exp_avg_sq"][k]).reshape(-1).float().numpy()}
                for i, k in enumerate(named)}
        self._host_opt.load_state_dict({"step": int(state["count"]), "state": flat})

    # -- data ----------------------------------------------------------------
    def deepspeed_io(self, dataset, batch_size: Optional[int] = None,
                     collate_fn: Optional[Callable] = None) -> DeepSpeedDataLoader:
        """A training dataloader over ``dataset`` of ``train_batch_size``
        samples a batch, shuffled from the config's seed (JAX
        ``engine.py:2032``)."""
        return DeepSpeedDataLoader(dataset, batch_size=batch_size or self.config.train_batch_size,
                                   collate_fn=collate_fn, drop_last=self.config.dataloader_drop_last,
                                   seed=self.config.seed)

    def _training_iterator(self):
        """The training dataloader's iterator, kept across calls and
        restarted at each epoch's end."""
        if self.training_dataloader is None:
            return None
        if self._train_iter is None:
            self._train_iter = iter(RepeatingLoader(self.training_dataloader))
        return self._train_iter

    # -- diagnostics ---------------------------------------------------------
    @torch.no_grad()
    def moe_gate_stats(self, batch) -> dict:
        """Per-MoE-layer expert load from one train-mode forward of
        ``batch`` under ``no_grad`` (the train capacity factor, RTS and
        gating noise live; JAX ``engine.py:2283-2337``): ``{layer:
        {"exp_counts": [E], "kept_counts": [E], "routed_counts": [E] (where
        the route gives it), "capacity_slots": int}}``, numpy arrays. Its
        draws come from a generator seeded from ``(seed, global_steps)``, as
        JAX folds the step into its key, never from ``self.generator``: a
        stats call leaves the next training step as it was."""
        seed = np.random.SeedSequence([self.config.seed, self.global_steps]).generate_state(1, np.uint64)
        gen = torch.Generator(device=self.device).manual_seed(int(seed[0]))
        self._run_module(self._stage(batch)["input_ids"], deterministic=False, generator=gen)
        stats = {}
        for name, layer in self.module.named_modules():
            if isinstance(layer, MOELayer):
                entry = {"exp_counts": layer.exp_counts.cpu().numpy(),
                         "kept_counts": layer.kept_counts.cpu().numpy(),
                         "capacity_slots": int(layer.capacity_slots)}
                if layer.routed_counts is not None:
                    entry["routed_counts"] = layer.routed_counts.cpu().numpy()
                stats[name] = entry
        return stats

    def retain_grads(self, flag: bool = True) -> None:
        """Keep each step's gradients, averaged over the accumulation window
        and before clipping (JAX ``engine.py:2339, 2418-2425``), for
        ``utils.tensor_fragment.safe_get_full_grad``."""
        self._retain_grads = bool(flag)
        if not flag:
            self._retained_grads = None

    def retained_grad(self, name: str) -> Optional[torch.Tensor]:
        """Parameter ``name``'s retained gradient (a view), or None when no
        step has retained one."""
        if self._retained_grads is None:
            return None
        if name not in self._grad_slices:
            raise KeyError(f"no parameter named {name!r}")
        params = dict(self.module.named_parameters())
        return self._retained_grads[self._grad_slices[name]].view_as(params[name])

    # -- checkpoints -----------------------------------------------------------
    def checkpoint_state(self) -> Dict[str, torch.Tensor]:
        """The flat state a checkpoint holds: ``module/<name>`` the fp32
        parameters and ``optimizer/exp_avg/<name>``,
        ``optimizer/exp_avg_sq/<name>`` the Adam moments (the live tensors),
        ``optimizer/count`` the Adam count and ``rng/generator`` the state of
        ``self.generator`` (host tensors made now). Under
        ``offload_optimizer`` the moments are the host optimizer's:
        ``host_optimizer/exp_avg/<name>``, ``host_optimizer/exp_avg_sq/<name>``
        and ``host_optimizer/step``."""
        self._ensure_params_resident()
        named = dict(self.module.named_parameters())
        state = {f"{MODULE_GROUP}/{k}": p for k, p in named.items()}
        if self.client_optimizer is not None:
            state.update(self._client_optimizer_state(named))
        elif self._host_opt is None:
            opt = self.optimizer.named_state(named)
            for key, by_name in opt.items():
                if key != "count":
                    state.update({f"{OPTIMIZER_GROUP}/{key}/{k}": t for k, t in by_name.items()})
            state[f"{OPTIMIZER_GROUP}/count"] = torch.tensor(opt["count"], dtype=torch.int64)
        else:
            state.update(self._host_optimizer_state(named))
        state[RNG_KEY] = self.generator.get_state()
        if self.config.fp16_enabled:
            ls = self._ls_state
            state[f"{LOSS_SCALE_GROUP}/loss_scale"] = torch.tensor(ls.loss_scale, dtype=torch.float32)
            state[f"{LOSS_SCALE_GROUP}/good_steps"] = torch.tensor(ls.good_steps, dtype=torch.int64)
            state[f"{LOSS_SCALE_GROUP}/hysteresis"] = torch.tensor(ls.hysteresis, dtype=torch.int64)
        return state

    def _client_optimizer_state(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A client optimizer's per-parameter state tensors (the live ones),
        keyed ``optimizer/client/<param name>/<state key>``; a number in its
        state travels as a 0-d tensor."""
        out = {}
        for name, p in named.items():
            for key, value in self.client_optimizer.state.get(p, {}).items():
                if value is None:
                    continue
                if not isinstance(value, torch.Tensor):
                    value = torch.tensor(value)
                    self.client_optimizer.state[p][key] = value
                out[f"{OPTIMIZER_GROUP}/{CLIENT_PREFIX}/{name}/{key}"] = value
        return out

    def _client_state_like(self, load_dir: str, tag: str,
                           state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``state`` with the client optimizer's entries made to match the
        tag's: a state entry the optimizer does not hold yet (a fresh
        engine, before its first step) is created with the tag's shape and
        dtype, so that the load fills it in place."""
        path = os.path.join(load_dir, tag, STATE_DIR, f"{OPTIMIZER_GROUP}.pt")
        try:
            saved = torch.load(path, map_location="cpu", weights_only=True)
        except (OSError, EOFError, RuntimeError, ValueError, pickle.UnpicklingError) as e:
            raise CheckpointCorruptError(f"{path} failed to deserialize: {e}") from e
        named = dict(self.module.named_parameters())
        prefix = f"{OPTIMIZER_GROUP}/{CLIENT_PREFIX}/"
        out = {k: v for k, v in state.items() if not k.startswith(prefix)}
        for full, t in saved.items():
            name, slot = full[len(prefix):].rsplit("/", 1) if full.startswith(prefix) else ("", "")
            if name not in named:
                continue  # another optimizer's or model's tag: the load names the difference
            p = named[name]
            live = self.client_optimizer.state[p].get(slot)
            if not isinstance(live, torch.Tensor) or live.shape != t.shape or live.dtype != t.dtype:
                live = torch.zeros_like(t, device=p.device if t.dim() else t.device)
                self.client_optimizer.state[p][slot] = live
            out[full] = live
        return out

    def _host_optimizer_state(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The host optimizer's step and moments, keyed by parameter name:
        the live moment arrays (``DeepSpeedCPUAdam``) or their read-back
        (``NVMeAdam``)."""
        opt = self._host_opt
        if isinstance(opt, NVMeAdam):
            moments = opt.state_dict()["state"]
            step = opt.step_count
        else:
            moments = {str(i): opt.ensure_state(i, p.numel()) for i, p in enumerate(named.values())}
            step = opt.step_count
        g = HOST_OPTIMIZER_GROUP
        state = {f"{g}/step": torch.tensor(step, dtype=torch.int64)}
        for i, (name, p) in enumerate(named.items()):
            st = moments.get(str(i))
            for key, short in (("exp_avg", "m"), ("exp_avg_sq", "v")):
                t = (torch.from_numpy(st[short]) if st is not None
                     else torch.zeros(p.numel(), dtype=torch.float32))
                state[f"{g}/{key}/{name}"] = t.view(p.shape)
        return state

    def host_optimizer_state(self, name: str) -> Dict[str, torch.Tensor]:
        """Parameter ``name``'s host optimizer state, ``{"exp_avg",
        "exp_avg_sq"}`` shaped as the parameter (copies)."""
        named = dict(self.module.named_parameters())
        g = HOST_OPTIMIZER_GROUP
        state = self._host_optimizer_state(named)
        return {key: state[f"{g}/{key}/{name}"].clone() for key in ("exp_avg", "exp_avg_sq")}

    def refresh_host_master(self, name: str) -> None:
        """After a write into parameter ``name`` outside the step: copy it
        into its host master, where the master is a tensor of its own."""
        if self._host_masters is None or self._param_offload:
            return
        named = list(self.module.named_parameters())
        i = [k for k, _ in named].index(name)
        with torch.no_grad():
            self._host_masters[i].copy_(named[i][1])

    def _load_host_optimizer(self, state: Optional[Dict[str, torch.Tensor]], reset: bool) -> None:
        """After a load: the host optimizer takes the loaded step and
        moments (``state``), or is reset (``reset``: a tag saved without
        offload), or keeps its own (neither: the optimizer state was not
        asked for); the masters are rebuilt from the loaded parameters."""
        opt, g = self._host_opt, HOST_OPTIMIZER_GROUP
        named = dict(self.module.named_parameters())
        if reset:
            opt.reset_state()
            if isinstance(opt, DeepSpeedCPUAdam):
                for i, p in enumerate(named.values()):
                    opt.ensure_state(i, p.numel())
        elif state is None:
            pass
        elif isinstance(opt, NVMeAdam):
            opt.load_state_dict({"step": int(state[f"{g}/step"]), "state": {
                str(i): {"m": state[f"{g}/exp_avg/{k}"].reshape(-1).numpy(),
                         "v": state[f"{g}/exp_avg_sq/{k}"].reshape(-1).numpy()}
                for i, k in enumerate(named)}})
        else:
            opt.step_count = int(state[f"{g}/step"])  # the moments were loaded in place
        if not self._param_offload:
            with torch.no_grad():
                for m, p in zip(self._host_masters, named.values()):
                    m.copy_(p.view(m.shape))

    def save_checkpoint(self, save_dir: str, tag=None, client_state: Optional[dict] = None,
                        save_latest: bool = True) -> bool:
        """Save the training state as ``save_dir/<tag>`` (default
        ``global_step<N>``), staged and published atomically, and point
        ``save_dir/latest`` at it. ``client_state`` must be JSON. A pending
        async save is committed first. Synchronous by default: the tag is
        durable when this returns. Under ``nebula.enabled`` the call takes a
        snapshot and returns; the tag and ``latest`` appear at
        ``flush_checkpoints`` (or the next save, a load or ``resume``).
        Raises ``RuntimeError`` inside an open accumulation window, whose
        half-summed gradients a checkpoint does not hold, and under
        ``quantize_training`` between a ``forward`` and its ``backward``."""
        self._moq_refuse_pending("save_checkpoint")
        if self._window_open:
            raise RuntimeError(f"save_checkpoint inside an open accumulation window (micro_steps "
                               f"{self.micro_steps}, gas {self.config.gradient_accumulation_steps}): "
                               f"save after the window's step()")
        self.flush_checkpoints()  # one pending async save at a time
        tag = str(tag or f"global_step{self.global_steps}")
        meta = {"global_steps": self.global_steps, "global_samples": self.global_samples,
                "micro_steps": self.micro_steps, "skipped_steps": self.skipped_steps,
                "world_size": 1, "client_state": client_state or {}}
        if self.curriculum_scheduler is not None:
            meta["curriculum_state"] = self.curriculum_scheduler.get_state()
        engine = TorchCheckpointEngine(save_dir)
        if self.config.nebula_config.enabled:
            if self._snapshot_pool is None:
                self._snapshot_pool = HostSnapshotPool()
            self._snapshot_ready = engine.save(self.checkpoint_state(), tag, metadata=meta,
                                               use_async=True, pool=self._snapshot_pool)
            self._pending_ckpt = (engine, save_dir, tag, save_latest)
            self._register_exit_flush()
            logger.info(f"snapshot checkpoint {tag} at step {self.global_steps} -> {save_dir}; "
                        f"published at the next flush")
            return True
        engine.save(self.checkpoint_state(), tag, metadata=meta)
        if save_latest:
            write_atomic_text(os.path.join(save_dir, LATEST_NAME), tag)
        logger.info(f"saved checkpoint {tag} at step {self.global_steps} -> {save_dir}")
        return True

    def flush_checkpoints(self) -> None:
        """Commit the pending async save, if any (the persist boundary of
        JAX's Nebula-style saves): wait for its writer, raise any error it
        hit, publish the tag atomically, then write its ``latest``
        marker. A no-op after a synchronous save."""
        pending, self._pending_ckpt = self._pending_ckpt, None
        if pending is None:
            return
        engine, save_dir, tag, save_latest = pending
        self._snapshot_ready = None  # the writer waited on the snapshot before it finished
        engine.commit(tag)
        if save_latest:
            write_atomic_text(os.path.join(save_dir, LATEST_NAME), tag)
        logger.info(f"published checkpoint {tag} at {save_dir}")

    def _register_exit_flush(self) -> None:
        """Commit a save still pending at a normal interpreter exit (a
        ``SystemExit`` included), from threading's exit hooks, which run
        before the interpreter joins its threads (JAX ``engine.py:2875-2890``)."""
        if self._flush_at_exit:
            return
        ref = weakref.ref(self)

        def _flush_on_exit():
            engine = ref()
            if engine is not None:
                try:
                    engine.flush_checkpoints()
                except Exception as e:  # noqa: BLE001 (the exit path can only report)
                    logger.error(f"exit-time checkpoint flush failed: {type(e).__name__}: {e}")

        threading._register_atexit(_flush_on_exit)
        self._flush_at_exit = True

    # -- preemption (JAX ``engine.py:2685-2742``) --------------------------------
    def enable_preemption_checkpoint(self, save_dir: str, signals=None, exit_after_save=None,
                                     exit_code=None) -> PreemptionGuard:
        """Arm preemption-safe checkpointing: SIGTERM/SIGINT (or
        ``signals``) set a flag, and the next step boundary saves a verified
        checkpoint to ``save_dir``, then raises ``SystemExit(exit_code)``
        (143 by default, so that a supervisor relaunches instead of reading
        the exit as the job's end) unless ``exit_after_save`` is false. The
        ``resilience.preempt_save_dir`` key arms this at init."""
        self._preempt_save_dir = save_dir
        if exit_after_save is not None:
            self._preempt_exit = bool(exit_after_save)
        if exit_code is not None:
            self._preempt_exit_code = int(exit_code)
        if self._preemption is not None:
            self._preemption.uninstall()
        self._preemption = PreemptionGuard(signals or self.config.resilience_config.preempt_signals
                                           ).install()
        logger.info(f"preemption checkpointing armed: {self._preemption.signal_names} -> checkpoint "
                    f"at the next step boundary -> {save_dir}")
        return self._preemption

    def _maybe_preempt_checkpoint(self) -> None:
        guard = self._preemption
        if guard is None or not guard.requested:
            return
        sig = guard.consume()
        logger.warning(f"preemption signal {sig}: checkpointing at step boundary "
                       f"{self.global_steps} -> {self._preempt_save_dir}")
        self.save_checkpoint(self._preempt_save_dir)
        self.flush_checkpoints()  # durable before the exit below
        if self._preempt_exit:
            logger.warning(f"preemption checkpoint durable; exiting {self._preempt_exit_code}")
            raise SystemExit(self._preempt_exit_code)

    def load_checkpoint(self, load_dir: str, tag=None, load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True, load_module_only: bool = False):
        """Load ``load_dir/<tag>`` (default: the tag ``latest`` names) into
        the live tensors in place. Returns ``(load_dir, client_state)``, or
        ``(None, {})`` when there is no ``latest``. Under the config's
        ``resilience.verify_checkpoint`` a corrupt tag falls back to the
        newest intact tag *older* than it, never a newer one
        (``fallback_on_corruption``); with none left it raises
        ``CheckpointCorruptError``. ``load_module_only`` takes the
        parameters alone; ``load_optimizer_states=False`` all but the
        optimizer state. The counters are restored in every case, as in
        JAX; the LR schedules are functions of the step and have no state
        of their own (``load_lr_scheduler_states`` has nothing to load). A
        pending async save is committed first. Raises ``RuntimeError`` under
        ``quantize_training`` between a ``forward`` and its ``backward``."""
        self._moq_refuse_pending("load_checkpoint")
        self.flush_checkpoints()  # an async save must be durable before any load
        explicit_tag = tag is not None
        if tag is None:
            latest = os.path.join(load_dir, LATEST_NAME)
            if not os.path.exists(latest):
                logger.warning(f"no '{LATEST_NAME}' file at {load_dir}; nothing loaded")
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        tag = str(tag)
        cfg = self.config.resilience_config
        candidates = [tag]
        if cfg.fallback_on_corruption:
            tags = list_checkpoint_tags(load_dir)
            if tag in tags:
                older = tags[tags.index(tag) + 1:]
            elif not explicit_tag:
                # the marker's tag is too torn to list: every listed tag
                # predates the marker's save
                older = tags
            else:
                # an explicit tag of unknown position: a fallback could go
                # forward, so none is tried
                older = []
            candidates += [t for t in older if t != tag]
        engine = TorchCheckpointEngine(load_dir)
        state = self.checkpoint_state()
        meta, loaded_tag, last_err = None, None, None
        host_state = None
        for cand in candidates:
            cand_state = state
            host_state = None
            if self.client_optimizer is not None and not load_module_only:
                try:
                    cand_state = state = self._client_state_like(load_dir, cand, state)
                except CheckpointCorruptError as e:
                    last_err = e
                    logger.error(f"checkpoint {cand} at {load_dir} is corrupt: {e}")
                    if not cfg.fallback_on_corruption:
                        raise
                    continue
            if self._host_opt is not None:
                if os.path.exists(os.path.join(load_dir, cand, STATE_DIR, f"{HOST_OPTIMIZER_GROUP}.pt")):
                    host_state = state
                else:  # saved without offload: JAX's rebuild rule
                    cand_state = {k: v for k, v in state.items()
                                  if not k.startswith(HOST_OPTIMIZER_GROUP + "/")}
            try:
                meta = engine.load(cand_state, cand, load_optimizer_states=load_optimizer_states,
                                   load_module_only=load_module_only, verify=cfg.verify_checkpoint)
            except CheckpointCorruptError as e:
                last_err = e
                logger.error(f"checkpoint {cand} at {load_dir} is corrupt: {e}")
                if not cfg.fallback_on_corruption:
                    raise
                continue
            loaded_tag = cand
            break
        if loaded_tag is None:
            raise CheckpointCorruptError(f"no intact checkpoint under {load_dir} (tried "
                                         f"{candidates}); last error: {last_err}")
        if loaded_tag != tag:
            logger.error(f"fell back from corrupt checkpoint {tag} to the newest older intact "
                         f"tag {loaded_tag}: training resumes from the older state")
        if self.client_optimizer is not None:
            pass  # its state tensors were loaded in place
        elif self._host_opt is None:
            self.optimizer.count = int(state[f"{OPTIMIZER_GROUP}/count"])
        else:
            reset = host_state is None
            if reset:
                logger.warning(f"no host_optimizer state in {loaded_tag} at {load_dir}: the fp32 "
                               f"masters are rebuilt from the loaded parameters and the host "
                               f"optimizer's moments reset")
            if load_module_only or not load_optimizer_states:
                host_state = None
            self._load_host_optimizer(host_state, reset)
        self.generator.set_state(state[RNG_KEY])
        if self.config.fp16_enabled:
            g = LOSS_SCALE_GROUP
            self._ls_state = LossScaleState(loss_scale=float(state[f"{g}/loss_scale"]),
                                            good_steps=int(state[f"{g}/good_steps"]),
                                            hysteresis=int(state[f"{g}/hysteresis"]))
        self.global_steps = meta.get("global_steps", 0)
        self.global_samples = meta.get("global_samples", 0)
        self.micro_steps = meta.get("micro_steps", 0)
        self.skipped_steps = meta.get("skipped_steps", 0)
        if self.curriculum_scheduler is not None and "curriculum_state" in meta:
            self.curriculum_scheduler.set_state(meta["curriculum_state"])
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        self._pending_loss = None
        self._window_open = False
        self.loaded_checkpoint_tag = loaded_tag
        return load_dir, meta.get("client_state", {})

    def resume(self, load_dir: Optional[str] = None, tag=None):
        """Restore the newest intact checkpoint under ``load_dir`` (default:
        the armed preemption dir): commit a pending async save, sweep the
        staging dirs of crashed saves, then load ``tag``, or the tag
        ``latest`` names, or the newest tag when the marker is missing (a
        crash between publish and marker). Returns ``(tag, client_state)``,
        ``(None, {})`` when there is no checkpoint."""
        load_dir = load_dir or self._preempt_save_dir
        if not load_dir:
            raise ValueError("resume() needs a load_dir (or an armed resilience.preempt_save_dir)")
        self.flush_checkpoints()  # the sweep below would remove its live staging dir
        sweep_stale_staging(load_dir)
        tags = list_checkpoint_tags(load_dir)
        if not tags:
            logger.info(f"resume: no checkpoints under {load_dir}; fresh start")
            return None, {}
        if tag is None and not os.path.exists(os.path.join(load_dir, LATEST_NAME)):
            logger.warning(f"resume: {load_dir} has tags but no '{LATEST_NAME}' marker; using the "
                           f"newest tag")
            tag = tags[0]
        path, client = self.load_checkpoint(load_dir, tag=tag)
        if path is None:
            return None, {}
        return self.loaded_checkpoint_tag, client

    def resume_elastic(self, load_dir=None, tag=None):
        raise _later("resume_elastic (resharding across world sizes)", "8")

    def load_universal(self, universal_dir):
        raise _later("load_universal (universal checkpoints)", "8")

    def save_16bit_model(self, save_dir: str, output_file: Optional[str] = None) -> str:
        """The live parameters rounded to bf16, written as the JAX
        package's deployment npz (``checkpoint/zero_to_fp32.save_npz``:
        JAX paths, bf16 stored as its ``uint16`` bits with a ``__dtypes__``
        map), so either package's ``load_state_dict_from_npz`` reads the
        file. Returns the file's path."""
        self._ensure_params_resident()
        with torch.no_grad():
            sd = {k: (p.to(torch.bfloat16) if p.is_floating_point() else p)
                  for k, p in self.module.named_parameters()}
        os.makedirs(save_dir, exist_ok=True)
        out = os.path.join(save_dir, output_file or WEIGHTS_NAME)
        save_npz(out, sd)
        logger.info(f"saved 16-bit model weights -> {out}")
        return out

    # -- accessors (upstream ``engine.py:474-855``; one card) --------------------
    @property
    def global_rank(self) -> int:
        return 0

    @property
    def world_size(self) -> int:
        return 1

    @property
    def dp_world_size(self) -> int:
        return 1

    @property
    def mp_world_size(self) -> int:
        return 1

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def zero_optimization_stage(self) -> int:
        return self.config.zero_optimization_stage

    def gradient_clipping(self) -> float:
        return self.config.gradient_clipping

    def steps_per_print(self) -> int:
        return self.config.steps_per_print

    def bfloat16_enabled(self) -> bool:
        return self.config.bfloat16_enabled

    def fp16_enabled(self) -> bool:
        return self.config.fp16_enabled

    def dynamic_loss_scale(self) -> bool:
        """``loss_scale`` 0 under fp16 (JAX ``engine.py:2594``)."""
        return bool(self.config.fp16_enabled and self.config.fp16_config.loss_scale == 0)

    @property
    def cur_scale(self) -> float:
        """The live loss scale (1.0 outside fp16; JAX ``engine.py:2562``)."""
        return float(self._ls_state.loss_scale)

    def get_loss_scale(self) -> float:
        return self.cur_scale

    @property
    def loss_scale_state(self) -> LossScaleState:
        return self._ls_state

    def wall_clock_breakdown(self) -> bool:
        return bool(self.config.wall_clock_breakdown)

    @property
    def communication_data_type(self) -> torch.dtype:
        """The dtype gradients would reduce in (JAX ``engine.py:2619``): the
        configured one, else fp16 or bf16 as the precision is, else fp32.
        One card reduces nothing."""
        resolved = comm_dtype(self.config.communication_data_type)
        if resolved is not None:
            return getattr(torch, resolved)
        if self.config.communication_data_type is not None:
            return torch.float32
        if self.fp16_enabled():
            return torch.float16
        if self.bfloat16_enabled():
            return torch.bfloat16
        return torch.float32

    def zero_offload_optimizer(self):
        """The ``offload_optimizer`` block (None when the config has none)."""
        return self.config.zero_config.offload_optimizer

    def zero_offload_param(self):
        """The ``offload_param`` block (None when the config has none)."""
        return self.config.zero_config.offload_param

    def sparse_gradients_enabled(self) -> bool:
        return bool(self.config.sparse_gradients_enabled)

    def get_lr(self):
        if self.lr_scheduler is not None:
            return [float(self.lr_scheduler(self.global_steps))]
        return [(self.config.optimizer_params or {}).get("lr", 1e-3)]

    def get_global_grad_norm(self) -> Optional[float]:
        return None if self._last_grad_norm is None else float(self._last_grad_norm)
