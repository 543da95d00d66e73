"""DeepSpeedEngine: the training step (the subset of
``deepspeed_tpu/runtime/engine.py`` that the GPT-2 training step runs).

One step of ``train_batch`` (JAX ``engine.py:849-925, 1886-1934``):

1. split the global batch into ``[gas, micro, ...]``;
2. forward and backward per micro-batch, gradients summed in fp32;
3. divide by ``gas``;
4. ``gnorm = global_norm_l2(grads)``; ``overflow = not isfinite(gnorm)``;
5. clip by ``min(1, clip / (gnorm + 1e-6))`` when ``clip > 0``;
6. unless ``overflow``, the optimizer update. On overflow the parameters
   and the Adam count stay as they were; the step counter still advances.

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

from typing import Callable, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.gpt2 import cross_entropy_loss
from deepspeed_tpu_torch.moe import routing as moe_routing
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.runtime.config import ADAMW_OPTIMIZER, DeepSpeedConfig
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.utils import global_norm_l2


def default_causal_lm_loss(outputs, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy of logits over ``labels`` (default:
    ``input_ids``). An MoE model's ``(logits, aux_loss)`` adds the
    (already scaled) load-balancing loss."""
    labels = batch.get("labels", batch["input_ids"])
    logits, aux_loss = outputs if isinstance(outputs, (tuple, list)) else (outputs, 0.0)
    return cross_entropy_loss(logits[:, :-1], labels[:, 1:]) + aux_loss


class DeepSpeedEngine:

    def __init__(self, model, config: DeepSpeedConfig, loss_fn: Optional[Callable] = None,
                 lr_scheduler: Optional[Callable[[int], float]] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        mcfg = model.config
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device} but the engine runs on "
                             f"{self.device}; build the model with device={str(self.device)!r}")
        if mcfg.param_dtype != torch.float32 or mcfg.serve_weight_dtype is not None:
            raise ValueError("training needs fp32 master parameters (GPT2Config.param_dtype="
                             "torch.float32, serve_weight_dtype=None)")
        if config.bfloat16_enabled and mcfg.dtype != torch.bfloat16:
            raise ValueError("bf16 is enabled but the model computes in "
                             f"{mcfg.dtype}; build it with GPT2Config.dtype=torch.bfloat16")
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
        self._last_grad_norm: Optional[torch.Tensor] = None

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
        ``initialize``). Idempotent; ``train_batch`` calls it."""
        if self._grads is not None:
            return
        params = list(self.module.parameters())
        self._grads = torch.zeros(sum(p.numel() for p in params), dtype=torch.float32,
                                  device=self.device)
        offset = 0
        for p in params:
            p.grad = self._grads[offset:offset + p.numel()].view_as(p)
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
        stochastic = train and (mcfg.dropout > 0.0 or moe)
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

    def train_batch(self, batch) -> torch.Tensor:
        """One optimization step over a global batch (dict of [batch, ...]
        arrays or tensors, or the ``input_ids`` alone). Returns the mean
        micro-batch loss (fp32 scalar on the device)."""
        self.initialize_state(batch)
        cfg = self.config
        gas = cfg.gradient_accumulation_steps
        staged = self._stage(batch)
        n = staged["input_ids"].shape[0]
        if n != cfg.train_batch_size:
            raise ValueError(f"train_batch got {n} samples; train_batch_size is "
                             f"{cfg.train_batch_size}")
        micro = {k: v.reshape((gas, n // gas) + tuple(v.shape[1:])) for k, v in staged.items()}
        grads = self._grads
        grads.zero_()
        losses = []
        for i in range(gas):
            loss = self._loss_for({k: v[i] for k, v in micro.items()}, train=True)
            loss.backward()
            losses.append(loss.detach().float())
        grads.div_(gas)
        gnorm = global_norm_l2([grads])
        overflow = not bool(torch.isfinite(gnorm))
        if cfg.gradient_clipping > 0:
            grads.mul_(torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0))
        if overflow:
            self.skipped_steps += 1
        else:
            self.optimizer.step()
        self._last_grad_norm = gnorm
        self.global_steps += 1
        self.global_samples += cfg.train_batch_size
        self.micro_steps += gas
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

    # ------------------------------------------------------------------
    def get_lr(self):
        if self.lr_scheduler is not None:
            return [float(self.lr_scheduler(self.global_steps))]
        return [(self.config.optimizer_params or {}).get("lr", 1e-3)]

    def get_global_grad_norm(self) -> Optional[float]:
        return None if self._last_grad_norm is None else float(self._last_grad_norm)
