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
parameter's ``.grad`` is a view of the flat buffer. Saves are synchronous
and verified loads fall back to older intact tags (``runtime/resilience``).

An MoE model (``moe_num_experts > 0``) trains with training-mode gating
(``deterministic=False``, the train capacity factor and the gating noise)
even at dropout 0, as the JAX engine does; its load-balancing loss is part
of the training loss and not of ``eval_batch``'s. The config's ``"moe"``
block installs the default dispatch route for the engine's life (cleared
by an engine without one).

The model holds fp32 master parameters and computes in its config's
``dtype``, rounding each parameter to it where it is used (the JAX engine
casts the whole tree before ``apply``). The JAX engine ran the step as one
jitted program and ``train_batches`` as a ``lax.scan``; here they are
Python loops over eager PyTorch (a CUDA graph is later work). The
gradients live in one flat fp32 buffer, each parameter's ``.grad`` a view
of it, so the norm, the division and the clipping are one launch each.
"""

import json
import logging
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.from_jax import params_to_jax
from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.common import cross_entropy_loss
from deepspeed_tpu_torch.moe import routing as moe_routing
from deepspeed_tpu_torch.moe.sharded_moe import MOELayer
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_engine import (MODULE_GROUP,
                                                                        OPTIMIZER_GROUP,
                                                                        TorchCheckpointEngine)
from deepspeed_tpu_torch.runtime.config import ADAMW_OPTIMIZER, DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.resilience.manifest import (CheckpointCorruptError,
                                                             dtype_name, list_checkpoint_tags,
                                                             sweep_stale_staging,
                                                             write_atomic_text)
from deepspeed_tpu_torch.runtime.utils import global_norm_l2

logger = logging.getLogger(__name__)

#: the JAX package's deployment weights file (``checkpoint/zero_to_fp32.py``)
WEIGHTS_NAME = "model_weights.npz"
LATEST_NAME = "latest"
#: the checkpoint leaf of ``self.generator``'s state
RNG_KEY = "rng/generator"


def default_causal_lm_loss(outputs, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy of logits over ``labels`` (default:
    ``input_ids``). An MoE model's ``(logits, aux_loss)`` adds the
    (already scaled) load-balancing loss."""
    labels = batch.get("labels", batch["input_ids"])
    logits, aux_loss = outputs if isinstance(outputs, (tuple, list)) else (outputs, 0.0)
    return cross_entropy_loss(logits[:, :-1], labels[:, 1:]) + aux_loss


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} belongs to a later slice of the PyTorch port "
                               f"(ROADMAP.md Queue A item {item})")


class DeepSpeedEngine:

    def __init__(self, model, config: DeepSpeedConfig, loss_fn: Optional[Callable] = None,
                 lr_scheduler: Optional[Callable[[int], float]] = None, device: DeviceLike = None,
                 training_data=None, collate_fn: Optional[Callable] = None):
        self.device = resolve_device(device)
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
        self.module = model
        self.config = config
        moe_routing.set_default_route(config.moe_route, config.moe_kernel)
        self.loss_fn = loss_fn or default_causal_lm_loss
        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is None and config.scheduler_name is not None:
            self.lr_scheduler = get_lr_schedule(config.scheduler_name, config.scheduler_params)
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

    def _configure_optimizer(self) -> FusedAdam:
        params = dict(self.config.optimizer_params or {})
        lr = params.pop("lr", 1e-3)
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler
        adam_w_mode = params.pop("adam_w_mode", self.config.optimizer_name == ADAMW_OPTIMIZER)
        params.pop("torch_adam", None)
        params.pop("fused", None)
        if "betas" in params:
            params["betas"] = tuple(params["betas"])
        return FusedAdam(self.module.parameters(), lr=lr, adam_w_mode=adam_w_mode, **params)

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
        for name, p in named:
            self._grad_slices[name] = slice(offset, offset + p.numel())
            p.grad = self._grads[self._grad_slices[name]].view_as(p)
            offset += p.numel()

    def _stage(self, batch) -> dict:
        if not isinstance(batch, dict):
            batch = {"input_ids": batch}
        return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def _loss_for(self, mb: dict, train: bool) -> torch.Tensor:
        mcfg = self.module.config
        ids = mb["input_ids"]
        moe = mcfg.moe_num_experts > 0
        # a family without dropout (LLaMA) has no ``dropout`` field
        stochastic = train and (getattr(mcfg, "dropout", 0.0) > 0.0 or moe)
        kwargs = dict(deterministic=not stochastic,
                      generator=self.generator if stochastic else None)
        # a fused-head model computes the loss itself (no [B, L, V] logits);
        # only the default loss knows that contract
        fused_head = self.loss_fn is default_causal_lm_loss and mcfg.fused_head_loss_chunk > 0
        if fused_head:
            kwargs["labels"] = mb.get("labels", ids)
        outputs = self.module(ids, **kwargs)
        if not train and moe and isinstance(outputs, (tuple, list)):
            # eval reports the pure cross-entropy: the load-balancing loss
            # regularizes training only
            outputs = outputs[0]
        return outputs if fused_head else self.loss_fn(outputs, mb)

    # -- the training loop -------------------------------------------------
    def forward(self, batch) -> torch.Tensor:
        """The training loss of one micro-batch (a dict of ``[micro, ...]``
        arrays or tensors, or the ``input_ids`` alone), with its graph;
        ``backward`` consumes it. Dropout and MoE gating draw from
        ``self.generator``."""
        self.initialize_state()
        self._pending_loss = self._loss_for(self._stage(batch), train=True)
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
        loss.backward()
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
        grads.div_(cfg.gradient_accumulation_steps)
        if self._retain_grads:
            self._retained_grads = grads.clone()
        gnorm = global_norm_l2([grads])
        overflow = not bool(torch.isfinite(gnorm))
        if cfg.gradient_clipping > 0:
            grads.mul_(torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0))
        if overflow:
            self.skipped_steps += 1
        else:
            self.optimizer.step()
        self._last_grad_norm = gnorm
        self._window_open = False
        self.global_steps += 1
        self.global_samples += cfg.train_batch_size

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
        cfg = self.config
        gas = cfg.gradient_accumulation_steps
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
        """The loss of the whole batch, deterministic (no dropout)."""
        return self._loss_for(self._stage(batch), train=False)

    def load_optimizer_state(self, state: dict) -> None:
        """Load an optimizer state keyed by parameter name (e.g.
        ``checkpoint.from_jax.opt_state_from_jax``)."""
        self.optimizer.load_named_state(dict(self.module.named_parameters()), state)

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
        self.module(self._stage(batch)["input_ids"], deterministic=False, generator=gen)
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
        ``self.generator`` (host tensors made now)."""
        named = dict(self.module.named_parameters())
        opt = self.optimizer.named_state(named)
        state = {f"{MODULE_GROUP}/{k}": p for k, p in named.items()}
        for key in ("exp_avg", "exp_avg_sq"):
            state.update({f"{OPTIMIZER_GROUP}/{key}/{k}": t for k, t in opt[key].items()})
        state[f"{OPTIMIZER_GROUP}/count"] = torch.tensor(opt["count"], dtype=torch.int64)
        state[RNG_KEY] = self.generator.get_state()
        return state

    def save_checkpoint(self, save_dir: str, tag=None, client_state: Optional[dict] = None,
                        save_latest: bool = True) -> bool:
        """Save the training state as ``save_dir/<tag>`` (default
        ``global_step<N>``), staged and published atomically, and point
        ``save_dir/latest`` at it. ``client_state`` must be JSON. The save
        is synchronous: the tag is durable when this returns. Raises
        ``RuntimeError`` inside an open accumulation window, whose
        half-summed gradients a checkpoint does not hold."""
        if self._window_open:
            raise RuntimeError(f"save_checkpoint inside an open accumulation window (micro_steps "
                               f"{self.micro_steps}, gas {self.config.gradient_accumulation_steps}): "
                               f"save after the window's step()")
        tag = str(tag or f"global_step{self.global_steps}")
        meta = {"global_steps": self.global_steps, "global_samples": self.global_samples,
                "micro_steps": self.micro_steps, "skipped_steps": self.skipped_steps,
                "world_size": 1, "client_state": client_state or {}}
        TorchCheckpointEngine(save_dir).save(self.checkpoint_state(), tag, metadata=meta)
        if save_latest:
            write_atomic_text(os.path.join(save_dir, LATEST_NAME), tag)
        logger.info(f"saved checkpoint {tag} at step {self.global_steps} -> {save_dir}")
        return True

    def flush_checkpoints(self) -> None:
        """Commit pending async saves: a no-op, since saves are synchronous
        (async ``nebula`` saves are refused by the config)."""

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
        of their own (``load_lr_scheduler_states`` has nothing to load)."""
        explicit_tag = tag is not None
        if tag is None:
            latest = os.path.join(load_dir, LATEST_NAME)
            if not os.path.exists(latest):
                logger.warning(f"no '{LATEST_NAME}' file at {load_dir}; nothing loaded")
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        tag = str(tag)
        cfg = self.config
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
        for cand in candidates:
            try:
                meta = engine.load(state, cand, load_optimizer_states=load_optimizer_states,
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
        self.optimizer.count = int(state[f"{OPTIMIZER_GROUP}/count"])
        self.generator.set_state(state[RNG_KEY])
        self.global_steps = meta.get("global_steps", 0)
        self.global_samples = meta.get("global_samples", 0)
        self.micro_steps = meta.get("micro_steps", 0)
        self.skipped_steps = meta.get("skipped_steps", 0)
        self._pending_loss = None
        self._window_open = False
        self.loaded_checkpoint_tag = loaded_tag
        return load_dir, meta.get("client_state", {})

    def resume(self, load_dir: str, tag=None):
        """Restore the newest intact checkpoint under ``load_dir``: sweep
        the staging dirs of crashed saves, then load ``tag``, or the tag
        ``latest`` names, or the newest tag when the marker is missing (a
        crash between publish and marker). Returns ``(tag, client_state)``,
        ``(None, {})`` when there is no checkpoint."""
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
        package's deployment npz (``checkpoint/zero_to_fp32.py``
        ``save_npz``): under the JAX paths, bf16 stored as its ``uint16``
        bits with a ``__dtypes__`` map, so its ``load_state_dict_from_npz``
        reads the file. Returns the file's path."""
        with torch.no_grad():
            sd = {k: (p.to(torch.bfloat16) if p.is_floating_point() else p)
                  for k, p in self.module.named_parameters()}
        flat = params_to_jax(sd)  # keys in sd's order
        dtypes = {path: dtype_name(t.dtype) for path, t in zip(flat, sd.values())}
        os.makedirs(save_dir, exist_ok=True)
        out = os.path.join(save_dir, output_file or WEIGHTS_NAME)
        with open(out, "wb") as f:  # a file object: np.savez appends no ".npz"
            np.savez(f, __dtypes__=np.frombuffer(json.dumps(dtypes).encode(), np.uint8), **flat)
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
        return False  # fp16, and with it loss scaling, is refused by the config

    def wall_clock_breakdown(self) -> bool:
        return False

    def zero_offload_optimizer(self):
        return None  # offload is refused by the config

    def sparse_gradients_enabled(self) -> bool:
        return False

    def get_lr(self):
        if self.lr_scheduler is not None:
            return [float(self.lr_scheduler(self.global_steps))]
        return [(self.config.optimizer_params or {}).get("lr", 1e-3)]

    def get_global_grad_norm(self) -> Optional[float]:
        return None if self._last_grad_norm is None else float(self._last_grad_norm)
