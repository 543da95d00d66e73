"""Training config (the subset of ``deepspeed_tpu/runtime/config.py`` that
the port's training engine uses).

Read: the batch triangle (``train_batch_size``,
``train_micro_batch_size_per_gpu``, ``gradient_accumulation_steps``) on one
device, ``optimizer`` (Adam/AdamW), ``scheduler``, ``bf16``,
``gradient_clipping``, ``zero_optimization`` (every key of JAX's
``DeepSpeedZeroConfig``, ``runtime/zero/config.py``: stages 0-3, on one card
stages 1-3 train with stage 0's bits; ``offload_optimizer`` and
``offload_param`` on ``cpu`` and ``nvme``), ``steps_per_print``,
``seed``, ``dataloader_drop_last``, the ``"moe"`` block (``route``,
``kernel``: the MoE dispatch route and permutation, ``moe/routing.py``), and
every key of JAX's ``"resilience"`` and ``"nebula"`` blocks with their
defaults and bounds (``ResilienceConfig``, ``NebulaConfig``: JAX
``config.py:200-243``; ``nebula.enabled`` routes saves through the async
path, its other keys are taken as JAX takes them) and the ``"elasticity"``
block, which at one data-parallel rank overrides the batch triangle as JAX's
``_apply_elastic_config`` does, and the ``"hybrid_engine"`` block
(``HybridEngineConfig``: JAX ``config.py:46-55``; ``enabled`` makes
``initialize`` return the RLHF hybrid engine, one card only: an
``inference_tp_size`` above 1 raises). Everything else raises
``NotImplementedError`` naming the slice of the port it belongs to, so that
a setting is never dropped quietly: fp16 (the kernels take fp32 and bf16
only), the ZeRO keys that only mean something across ranks, other
optimizers, and any other block.
"""

import json
import logging
import os
from typing import Optional

from deepspeed_tpu_torch.elasticity.elasticity import ElasticityConfigError, compute_elastic_config
from deepspeed_tpu_torch.version import __version__

logger = logging.getLogger(__name__)

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"

#: optimizer params the port reads (``FusedAdam``'s arguments); the JAX
#: package's ``torch_adam`` and ``fused`` flags mean nothing there either
OPTIMIZER_PARAMS = ("lr", "betas", "eps", "weight_decay", "adam_w_mode", "bias_correction",
                    "torch_adam", "fused")

_KNOWN = ("train_batch_size", "train_micro_batch_size_per_gpu", "gradient_accumulation_steps",
          "optimizer", "scheduler", "bf16", "bfloat16", "fp16", "gradient_clipping",
          "zero_optimization", "steps_per_print", "seed", "moe", "dataloader_drop_last",
          "resilience", "nebula", "elasticity", "hybrid_engine")

#: keys of the ``"moe"`` block (JAX ``MoEConfig``)
MOE_KEYS = ("route", "kernel")

VERIFY_CHECKPOINT_MODES = ("off", "files", "full")

_TRUE = ("1", "on", "t", "true", "y", "yes")
_FALSE = ("0", "off", "f", "false", "n", "no")


class DeepSpeedConfigError(Exception):
    pass


def _coerce(where: str, kind: str, value):
    """``value`` as a field of type ``kind``, converted as JAX's config
    models (pydantic, lax mode) convert it; ``ValueError`` otherwise."""
    bad = ValueError(f"{where}: {value!r} is not a valid {kind}")
    optional = kind.endswith("?")
    kind = kind.rstrip("?")
    if value is None:
        if optional:
            return None
        raise bad
    if kind == "bool":
        if isinstance(value, bool):
            return value
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.lower() in _TRUE + _FALSE:
            return value.lower() in _TRUE
        raise bad
    if kind == "int":
        if isinstance(value, int):
            return int(value)
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str):
            try:
                return int(value.strip())
            except ValueError:
                raise bad from None
        raise bad
    if kind == "float":
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value.strip())
            except ValueError:
                raise bad from None
        raise bad
    if kind == "str":
        if isinstance(value, str):
            return value
        raise bad
    if kind == "list":
        if isinstance(value, (list, tuple)):
            return list(value)
        raise bad
    raise AssertionError(kind)


class _Block:
    """A config block read field by field: ``FIELDS`` maps each key to its
    kind, default and choices or lower bound. Unknown keys raise, as JAX's
    models (``extra="forbid"``) do, and ``"auto"`` takes the default, as
    JAX's non-strict models drop it."""

    NAME = ""
    FIELDS: dict = {}

    def __init__(self, raw: Optional[dict] = None):
        raw = dict(raw or {})
        unknown = sorted(set(raw) - set(self.FIELDS))
        if unknown:
            raise ValueError(f"unknown keys {unknown} in the {self.NAME} block; it takes "
                             f"{list(self.FIELDS)}")
        for key, (kind, default, limit) in self.FIELDS.items():
            value = raw.get(key, default)
            if isinstance(value, str) and value == "auto":
                value = default
            where = f"{self.NAME}.{key}"
            value = _coerce(where, kind, value)
            if isinstance(limit, tuple) and value not in limit:
                raise ValueError(f"{where} must be one of {list(limit)}, got {value!r}")
            if isinstance(limit, (int, float)) and value is not None and value < limit:
                raise ValueError(f"{where} must be >= {limit}, got {value!r}")
            setattr(self, key, value)


class ResilienceConfig(_Block):
    """JAX ``ResilienceConfig`` (``config.py:216-243``): the load-time
    integrity gate and its fallback, the overflow abort guard, the
    heartbeat cadence, and the preemption checkpoint (armed at engine init
    when ``preempt_save_dir`` is set)."""

    NAME = "resilience"
    FIELDS = {"verify_checkpoint": ("str", "full", VERIFY_CHECKPOINT_MODES),
              "fallback_on_corruption": ("bool", True, None),
              "max_consecutive_overflows": ("int", 0, 0),
              "heartbeat_interval": ("float", 2.0, 0.0),
              "preempt_save_dir": ("str?", None, None),
              "preempt_signals": ("list", ["SIGTERM", "SIGINT"], None),
              "exit_after_preempt_save": ("bool", True, None),
              "preempt_exit_code": ("int", 143, None)}


class NebulaConfig(_Block):
    """JAX ``NebulaConfig`` (``config.py:200-213``): ``enabled`` routes
    ``save_checkpoint`` through the async path (the tag and ``latest`` are
    published at ``flush_checkpoints`` or the next save); the storage and
    retention keys are taken as JAX takes them and change nothing."""

    NAME = "nebula"
    FIELDS = {"enabled": ("bool", False, None),
              "persistent_storage_path": ("str?", None, None),
              "persistent_time_interval": ("int?", None, None),
              "num_of_version_in_retention": ("int", 2, None),
              "enable_nebula_load": ("bool", True, None),
              "load_path": ("str?", None, None)}


class HybridEngineConfig(_Block):
    """JAX ``HybridEngineConfig`` (``config.py:46-55``): the RLHF train and
    serve engine's knobs. ``release_inference_cache``, ``pin_parameters``
    and ``tp_gather_partition_size`` are taken as JAX takes them and change
    nothing. Inference tensor parallelism
    (``inference_tp_size > 1``) needs several cards and raises."""

    NAME = "hybrid_engine"
    FIELDS = {"enabled": ("bool", False, None),
              "max_out_tokens": ("int", 512, None),
              "inference_tp_size": ("int", 1, None),
              "release_inference_cache": ("bool", False, None),
              "pin_parameters": ("bool", True, None),
              "tp_gather_partition_size": ("int", 8, None)}

    def __init__(self, raw: Optional[dict] = None):
        super().__init__(raw)
        if self.inference_tp_size > 1:
            raise NotImplementedError(
                f"hybrid_engine.inference_tp_size={self.inference_tp_size}: tensor-parallel "
                f"inference over several cards belongs to a later slice of the PyTorch port "
                f"(ROADMAP.md Queue A item 8); the hybrid engine serves on its one card")


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

        self.resilience_config = ResilienceConfig(config.get("resilience"))
        self.nebula_config = NebulaConfig(config.get("nebula"))
        self.elasticity_config = dict(config.get("elasticity") or {})
        self.hybrid_engine_config = HybridEngineConfig(config.get("hybrid_engine"))

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

        from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig

        self.zero_config = DeepSpeedZeroConfig(config.get("zero_optimization"))
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0

        triangle = (config.get("train_batch_size"), config.get("train_micro_batch_size_per_gpu"),
                    config.get("gradient_accumulation_steps"))
        if self.elasticity_enabled():
            triangle = self._elastic_triangle(triangle)
        self.train_batch_size, self.train_micro_batch_size_per_gpu, \
            self.gradient_accumulation_steps = self._resolve_batch(*triangle)

    def elasticity_enabled(self) -> bool:
        return bool(self.elasticity_config.get("enabled", False))

    def _elastic_triangle(self, user_triangle, dp_world_size: int = 1):
        """The batch triangle of the elastic plan at ``dp_world_size`` (JAX
        ``_apply_elastic_config``); explicit batch keys beside it raise
        unless ``ignore_non_elastic_batch_info`` is set."""
        explicit = [v for v in user_triangle if v is not None]
        if explicit and not self.elasticity_config.get("ignore_non_elastic_batch_info", False):
            raise ElasticityConfigError(
                "elasticity is enabled but train_batch_size/micro_batch/gas are also set; "
                "remove them or set elasticity.ignore_non_elastic_batch_info")
        final_batch, valid, micro = compute_elastic_config(
            {"elasticity": self.elasticity_config}, __version__, world_size=dp_world_size,
            return_microbatch=True)
        gas = final_batch // (micro * dp_world_size)
        logger.info(f"elasticity: world={dp_world_size} -> train_batch={final_batch} "
                    f"micro={micro} gas={gas} (valid card counts: {sorted(valid)[:8]}...)")
        return final_batch, micro, gas

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
