"""Training config (the subset of ``deepspeed_tpu/runtime/config.py`` that
the GPT-2 training step uses).

Read: the batch triangle (``train_batch_size``,
``train_micro_batch_size_per_gpu``, ``gradient_accumulation_steps``) on one
device, ``optimizer`` (Adam/AdamW), ``scheduler``, ``bf16``,
``gradient_clipping``, ``zero_optimization`` at stage 0, ``steps_per_print``,
``seed``, ``dataloader_drop_last``, the ``"moe"`` block (``route``,
``kernel``: the MoE dispatch route and permutation, ``moe/routing.py``) and
the ``"resilience"`` block's checkpoint keys (``verify_checkpoint``:
"off", "files" or "full", default "full"; ``fallback_on_corruption``,
default true; JAX ``config.py:221-238``). Everything else raises
``NotImplementedError`` naming the slice of the port it belongs to, so that
a setting is never dropped quietly: fp16 (the kernels take fp32 and bf16
only), ZeRO stages 1-3 and offload, other optimizers, the resilience
block's other keys (preemption, overflow abort, heartbeats), an enabled
``"nebula"`` block (async checkpoints), and any other block.
"""

import json
import os
from typing import Optional

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"

#: optimizer params the port reads (``FusedAdam``'s arguments); the JAX
#: package's ``torch_adam`` and ``fused`` flags mean nothing there either
OPTIMIZER_PARAMS = ("lr", "betas", "eps", "weight_decay", "adam_w_mode", "bias_correction",
                    "torch_adam", "fused")

_KNOWN = ("train_batch_size", "train_micro_batch_size_per_gpu", "gradient_accumulation_steps",
          "optimizer", "scheduler", "bf16", "bfloat16", "fp16", "gradient_clipping",
          "zero_optimization", "steps_per_print", "seed", "moe", "dataloader_drop_last",
          "resilience", "nebula")

#: keys of the ``"moe"`` block (JAX ``MoEConfig``)
MOE_KEYS = ("route", "kernel")

#: keys of the ``"resilience"`` block the port reads (JAX ``ResilienceConfig``)
RESILIENCE_KEYS = ("verify_checkpoint", "fallback_on_corruption")
VERIFY_CHECKPOINT_MODES = ("off", "files", "full")


class DeepSpeedConfigError(Exception):
    pass


def _later(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} belongs to the {where} slice of the PyTorch port")


class DeepSpeedConfig:
    """A parsed config dict (or JSON path), resolved for one device (one
    data-parallel rank)."""

    def __init__(self, config):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(f"Expected a string path to an existing deepspeed "
                                           f"config, got {config}")
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise ValueError(f"Expected a string path or dict, got: {config} ({type(config)})")
        unread = sorted(set(config) - set(_KNOWN))
        if unread:
            raise NotImplementedError(f"config blocks {unread} belong to later slices of the "
                                      f"PyTorch port, which reads only {list(_KNOWN)}")
        self.steps_per_print = int(config.get("steps_per_print", 10))
        self.seed = int(config.get("seed", 1234))
        self.gradient_clipping = float(config.get("gradient_clipping", 0.0))
        moe = dict(config.get("moe") or {})
        unknown = sorted(set(moe) - set(MOE_KEYS))
        if unknown:
            raise ValueError(f"unknown keys {unknown} in the moe block; it takes {list(MOE_KEYS)}")
        self.moe_route = moe.get("route")
        self.moe_kernel = moe.get("kernel")
        self.dataloader_drop_last = bool(config.get("dataloader_drop_last", False))

        resilience = dict(config.get("resilience") or {})
        unported = sorted(set(resilience) - set(RESILIENCE_KEYS))
        if unported:
            raise _later(f"resilience keys {unported}", "preemption and resilience")
        self.verify_checkpoint = resilience.get("verify_checkpoint", "full")
        if self.verify_checkpoint not in VERIFY_CHECKPOINT_MODES:
            raise ValueError(f"resilience.verify_checkpoint must be one of "
                             f"{list(VERIFY_CHECKPOINT_MODES)}, got {self.verify_checkpoint!r}")
        self.fallback_on_corruption = bool(resilience.get("fallback_on_corruption", True))
        if dict(config.get("nebula") or {}).get("enabled", False):
            raise _later("nebula (async checkpoint saves)", "async-checkpoint")

        opt = config.get("optimizer")
        self.optimizer_name = opt["type"].lower() if opt and "type" in opt else None
        self.optimizer_params = dict(opt.get("params", {})) if opt else None
        if self.optimizer_name not in (None, ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
            raise _later(f"optimizer {opt['type']!r}", "optimizers")
        unknown = sorted(set(self.optimizer_params or {}) - set(OPTIMIZER_PARAMS))
        if unknown:
            raise _later(f"optimizer params {unknown}", "optimizers")
        sched = config.get("scheduler")
        self.scheduler_name = sched["type"] if sched and "type" in sched else None
        self.scheduler_params = dict(sched.get("params", {})) if sched else None

        fp16 = dict(config.get("fp16", {}))
        if fp16.get("enabled", False):
            raise _later("fp16 (the kernels take fp32 and bf16)", "fp16/loss-scaling")
        self.fp16_enabled = False
        bf16 = dict(config.get("bf16", config.get("bfloat16", {})))
        self.bfloat16_enabled = bool(bf16.get("enabled", False))

        zero = dict(config.get("zero_optimization", {}))
        self.zero_optimization_stage = int(zero.pop("stage", 0))
        if self.zero_optimization_stage != 0:
            raise _later(f"ZeRO stage {self.zero_optimization_stage}", "ZeRO")
        for key, val in zero.items():
            if key.startswith("offload") and (val or {}).get("device", "none") not in (None, "none"):
                raise _later(f"zero_optimization.{key}", "offload")
            if not key.startswith("offload"):
                raise _later(f"zero_optimization.{key}", "ZeRO")

        self.train_batch_size, self.train_micro_batch_size_per_gpu, \
            self.gradient_accumulation_steps = self._resolve_batch(
                config.get("train_batch_size"), config.get("train_micro_batch_size_per_gpu"),
                config.get("gradient_accumulation_steps"))

    def _resolve_batch(self, train_batch: Optional[int], micro_batch: Optional[int],
                       grad_acc: Optional[int]):
        """Any two of the triangle determine the third (reference
        ``_configure_train_batch_size`` with one data-parallel rank)."""
        if train_batch is not None and micro_batch is not None and grad_acc is not None:
            pass
        elif train_batch is not None and micro_batch is not None:
            grad_acc = train_batch // micro_batch
        elif train_batch is not None and grad_acc is not None:
            micro_batch = train_batch // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            train_batch = micro_batch * grad_acc
        elif train_batch is not None:
            grad_acc = 1
            micro_batch = train_batch
        elif micro_batch is not None:
            train_batch = micro_batch
            grad_acc = 1
        else:
            raise DeepSpeedConfigError("Either train_batch_size or train_micro_batch_size_per_gpu "
                                       "needs to be set")
        if min(train_batch, micro_batch, grad_acc) <= 0 or \
                train_batch != micro_batch * grad_acc:
            raise DeepSpeedConfigError(f"Check batch related parameters. train_batch_size "
                                       f"{train_batch} != {micro_batch} * {grad_acc}")
        return train_batch, micro_batch, grad_acc
