"""Training config (counterpart of ``deepspeed_tpu/runtime/config.py`` for
one device, one data-parallel rank).

Every top-level key JAX's ``DeepSpeedConfig`` reads is either taken with
JAX's defaults and bounds or refused, one key at a time, with the reason
(:data:`REFUSED_KEYS`); a key JAX reads nowhere raises too, so that a
setting is never dropped quietly. Taken:

- the batch triangle (``train_batch_size``, ``train_micro_batch_size_per_gpu``,
  ``gradient_accumulation_steps``), ``steps_per_print``, ``seed``,
  ``gradient_clipping``, ``dataloader_drop_last``;
- ``optimizer``: ``adam``, ``adamw``, ``lamb``, ``adagrad``, ``sgd`` and
  ``lion`` with JAX's parameter names (``runtime/optimizers.py``; the
  one-bit types raise), and ``scheduler``;
- ``fp16`` (JAX ``FP16Config``: dynamic or static loss scaling,
  ``runtime/fp16/loss_scaler.py``; ``auto_cast`` and
  ``fp16_master_weights_and_grads`` are taken and change nothing, as in
  JAX: the masters stay fp32) and ``bf16``;
- the scalars ``dump_state``, ``wall_clock_breakdown`` (the engine's
  timers, ``utils/timer.py``), ``memory_breakdown``,
  ``prescale_gradients``, ``gradient_predivide_factor``,
  ``sparse_gradients``, ``communication_data_type`` (JAX's names and
  errors; one card reduces nothing) and ``disable_allgather``;
- the blocks ``zero_optimization`` (every key of JAX's
  ``DeepSpeedZeroConfig``, ``runtime/zero/config.py``), ``checkpoint``,
  ``activation_checkpointing``, ``program`` (JAX ``ProgramConfig``: knobs
  applied onto the model's config, with the ``DS_REMAT_POLICY`` and
  ``DS_LMHEAD_CHUNK`` env layer), ``attention`` (its ``policy``; the block
  geometry knobs are TPU grid policy and raise), ``progressive_layer_drop``,
  ``moe``, ``resilience``, ``nebula``, ``elasticity`` (at one rank it
  overrides the batch triangle as JAX's ``_apply_elastic_config`` does) and
  ``hybrid_engine`` (``enabled`` makes ``initialize`` return the RLHF
  hybrid engine; ``inference_tp_size`` above 1 raises);
- ``curriculum_learning`` (the engine truncates batches to the seqlen
  difficulty), ``quantize_training`` (MoQ, ``runtime/quantize.py``) and
  ``eigenvalue`` (its period factors, ``runtime/eigenvalue.py``), read by
  the engine as JAX's reads them; ``compression_training`` is stored and
  applied by ``compression.init_compression``, as in JAX;
  ``data_efficiency`` is stored and applied nowhere, as in JAX (its
  components, ``runtime/data_pipeline/``, are used by hand, as JAX's tests
  use them).
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

_KNOWN = ("train_batch_size", "train_micro_batch_size_per_gpu", "gradient_accumulation_steps",
          "optimizer", "scheduler", "bf16", "bfloat16", "fp16", "gradient_clipping",
          "zero_optimization", "steps_per_print", "seed", "moe", "dataloader_drop_last",
          "resilience", "nebula", "elasticity", "hybrid_engine", "dump_state",
          "wall_clock_breakdown", "memory_breakdown", "prescale_gradients",
          "gradient_predivide_factor", "sparse_gradients", "communication_data_type",
          "disable_allgather", "checkpoint", "activation_checkpointing", "program",
          "attention", "progressive_layer_drop", "data_efficiency", "curriculum_learning",
          "quantize_training", "eigenvalue", "compression_training")

#: the top-level keys JAX reads that the port refuses, with the reason
REFUSED_KEYS = {
    "mesh": "the mesh block lays a run over several cards; the port trains on one "
            "(ROADMAP.md Queue A item 8)",
    "comms_logger": "collective logging belongs to comm/ (ROADMAP.md Queue A item 8)",
    "tensorboard": "monitor/ is not ported (ROADMAP.md Queue A item 9)",
    "wandb": "monitor/ is not ported (ROADMAP.md Queue A item 9)",
    "csv_monitor": "monitor/ is not ported (ROADMAP.md Queue A item 9)",
    "flops_profiler": "profiling/ is not ported (ROADMAP.md Queue A item 9)",
    "trace_profiler": "profiling/ is not ported (ROADMAP.md Queue A item 9)",
    "telemetry": "the training half of runtime/telemetry/ is not ported (ROADMAP.md Queue A "
                 "item 9)",
    "autotuning": "autotuning/ is not ported (ROADMAP.md Queue A item 9)",
    "pipeline": "the pipeline engine (runtime/pipe/) spans several cards (ROADMAP.md Queue A "
                "item 8)",
}

#: JAX ``dtype_names`` (``config_utils.py``): ``communication_data_type``'s names
DTYPE_NAMES = {"float32": "float32", "fp32": "float32", "float": "float32",
               "float16": "float16", "fp16": "float16", "half": "float16",
               "bfloat16": "bfloat16", "bf16": "bfloat16", "int8": "int8"}

#: ``program`` block field -> the model-config field it lands on (JAX
#: ``PROGRAM_MODEL_FIELDS``)
PROGRAM_MODEL_FIELDS = {
    "remat": "remat",
    "remat_every": "remat_every",
    "remat_policy": "remat_policy",
    "lm_head_chunk": "fused_head_loss_chunk",
    "fused_qkv": "attn_fused_qkv",
    "fused_attn_out": "attn_fused_out",
}
#: the program block's env layer (JAX ``ENV_REMAT_POLICY``, ``ENV_LMHEAD_CHUNK``)
ENV_REMAT_POLICY = "DS_REMAT_POLICY"
ENV_LMHEAD_CHUNK = "DS_LMHEAD_CHUNK"

#: the ``attention`` block's TPU block-geometry knobs (JAX ``AttentionConfig``)
ATTENTION_GRID_KEYS = ("block_q", "block_k", "block_q_bwd", "block_k_bwd", "bwd_skip",
                       "cache_file")

#: keys of the ``"moe"`` block (JAX ``MoEConfig``)
MOE_KEYS = ("route", "kernel")

VERIFY_CHECKPOINT_MODES = ("off", "files", "full")

_TRUE = ("1", "on", "t", "true", "y", "yes")
_FALSE = ("0", "off", "f", "false", "n", "no")


class DeepSpeedConfigError(Exception):
    pass


def _no_duplicate_keys(pairs):
    """JSON object hook: a key given twice raises (JAX
    ``dict_raise_error_on_duplicate_keys``)."""
    keys = [k for k, _ in pairs]
    dup = sorted({k for k in keys if keys.count(k) > 1})
    if dup:
        raise ValueError(f"Duplicate keys in DeepSpeed config: {dup}")
    return dict(pairs)


def comm_dtype(name) -> Optional[str]:
    """``communication_data_type`` resolved as JAX's ``_comm_dtype``: None
    for none or fp32 (no recast), "float16" or "bfloat16"; ``ValueError``
    for a name JAX does not know or an integer type."""
    if name is None:
        return None
    resolved = DTYPE_NAMES.get(str(name).lower())
    if resolved is None or resolved == "int8":
        raise ValueError(f"communication_data_type {name!r}: expected fp16/bf16/fp32 "
                         f"(or float16/bfloat16/float32/half/float)")
    return None if resolved == "float32" else resolved


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
    if kind == "dict":
        if isinstance(value, dict):
            return dict(value)
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


class FP16Config(_Block):
    """JAX ``FP16Config`` (``config.py:29-39``): ``loss_scale`` 0 is dynamic
    scaling from ``2**initial_scale_power``."""

    NAME = "fp16"
    FIELDS = {"enabled": ("bool", False, None),
              "auto_cast": ("bool", False, None),
              "loss_scale": ("float", 0.0, 0.0),
              "initial_scale_power": ("int", 16, 0),
              "loss_scale_window": ("int", 1000, 1),
              "hysteresis": ("int", 2, 0),
              "consecutive_hysteresis": ("bool", False, None),
              "min_loss_scale": ("float", 1.0, 0.0),
              "fp16_master_weights_and_grads": ("bool", False, None)}


class CheckpointConfig(_Block):
    """JAX ``CheckpointConfig``: ``tag_validation``,
    ``use_node_local_storage`` and ``parallel_write`` are taken as JAX takes
    them (one rank has no tags to compare and one writer);
    ``load_universal`` raises (ROADMAP.md Queue A item 8)."""

    NAME = "checkpoint"
    FIELDS = {"tag_validation": ("str", "Warn", None),
              "load_universal": ("bool", False, None),
              "use_node_local_storage": ("bool", False, None),
              "parallel_write": ("dict", {}, None)}

    def __init__(self, raw: Optional[dict] = None):
        super().__init__(raw)
        if self.load_universal:
            raise NotImplementedError("checkpoint.load_universal: universal checkpoints belong "
                                      "to a later slice of the PyTorch port (ROADMAP.md Queue A "
                                      "item 8)")


class ActivationCheckpointingConfig(_Block):
    """JAX ``ActivationCheckpointingConfig`` (``config.py:58-67``), read by
    ``runtime/activation_checkpointing.configure`` (``cpu_checkpointing``
    applies in its ``checkpoint()``, as in JAX)."""

    NAME = "activation_checkpointing"
    FIELDS = {"partition_activations": ("bool", False, None),
              "contiguous_memory_optimization": ("bool", False, None),
              "cpu_checkpointing": ("bool", False, None),
              "number_checkpoints": ("int?", None, None),
              "synchronize_checkpoint_boundary": ("bool", False, None),
              "profile": ("bool", False, None)}


class ProgramConfig(_Block):
    """JAX ``ProgramConfig`` (``config.py:117-175``): unset knobs leave the
    model's config as it is; set ones land on it (``model_updates``)."""

    NAME = "program"
    FIELDS = {"remat": ("bool?", None, None),
              "remat_every": ("int?", None, 1),
              "remat_policy": ("str?", None, None),
              "lm_head_chunk": ("int?", None, 0),
              "fused_qkv": ("bool?", None, None),
              "fused_attn_out": ("bool?", None, None)}

    def model_updates(self) -> dict:
        """The set fields as ``{model_config_field: value}``; ``remat_policy``
        "none" is None, the full recompute."""
        out = {}
        for field, model_field in PROGRAM_MODEL_FIELDS.items():
            value = getattr(self, field)
            if value is None:
                continue
            if field == "remat_policy" and value == "none":
                value = None
            out[model_field] = value
        return out


def program_env_updates() -> dict:
    """The program knobs' env layer, ``{model_field: value}`` (JAX
    ``program_env_updates``): ``DS_REMAT_POLICY`` turns remat on with that
    policy ("" or "none": full recompute), ``DS_LMHEAD_CHUNK`` sets the
    fused head's chunk."""
    out = {}
    policy = os.environ.get(ENV_REMAT_POLICY)
    if policy is not None:
        out["remat_policy"] = None if policy in ("", "none") else policy
        out["remat"] = True
    chunk = os.environ.get(ENV_LMHEAD_CHUNK)
    if chunk is not None:
        out["fused_head_loss_chunk"] = int(chunk)
    return out


class AttentionConfig(_Block):
    """JAX ``AttentionConfig`` (``config.py:70``): ``policy`` (the flash
    backward's, ``ops/cuda/flash_attention.POLICIES``) lands on the model's
    config as ``attention_policy``, which checks it, as JAX checks it when
    its engine installs the block; the block geometry knobs raise, one at a
    time: they are TPU grid policy (the Hopper kernels have their own
    tiles)."""

    NAME = "attention"
    FIELDS = {"block_q": ("int?", None, 8),
              "block_k": ("int?", None, 8),
              "block_q_bwd": ("int?", None, 8),
              "block_k_bwd": ("int?", None, 8),
              "bwd_skip": ("str?", None, None),
              "policy": ("str?", None, None),
              "cache_file": ("str?", None, None)}

    def __init__(self, raw: Optional[dict] = None):
        super().__init__(raw)
        for key in ATTENTION_GRID_KEYS:
            if getattr(self, key) is not None:
                raise NotImplementedError(
                    f"attention.{key}: the JAX flash kernel's TPU block geometry (grid policy); "
                    f"the Hopper kernels have their own tiles and always skip dead ones")


class ProgressiveLayerDropConfig(_Block):
    """The ``progressive_layer_drop`` block as JAX reads it: ``enabled``,
    ``theta`` (0.5) and ``gamma`` (0.001)."""

    NAME = "progressive_layer_drop"
    FIELDS = {"enabled": ("bool", False, None),
              "theta": ("float", 0.5, None),
              "gamma": ("float", 0.001, None)}


class DeepSpeedConfig:
    """A parsed config dict (or JSON path), resolved for one device (one
    data-parallel rank)."""

    def __init__(self, config):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(f"Expected a string path to an existing deepspeed "
                                           f"config, got {config}")
            with open(config) as f:
                config = json.load(f, object_pairs_hook=_no_duplicate_keys)
        if not isinstance(config, dict):
            raise ValueError(f"Expected a string path or dict, got: {config} ({type(config)})")
        for key in sorted(set(config) - set(_KNOWN)):
            if key in REFUSED_KEYS:
                raise NotImplementedError(f"config key {key!r} belongs to a later slice of the "
                                          f"PyTorch port: {REFUSED_KEYS[key]}")
            raise NotImplementedError(f"config key {key!r} is no key of the JAX package's config; "
                                      f"the PyTorch port reads {list(_KNOWN)}")
        self.steps_per_print = int(config.get("steps_per_print", 10))
        # JAX reads these scalars as given (``get_scalar_param``)
        self.dump_state = config.get("dump_state", False)
        self.wall_clock_breakdown = config.get("wall_clock_breakdown", False)
        self.memory_breakdown = config.get("memory_breakdown", False)
        self.prescale_gradients = config.get("prescale_gradients", False)
        self.gradient_predivide_factor = config.get("gradient_predivide_factor", 1.0)
        self.sparse_gradients_enabled = config.get("sparse_gradients", False)
        self.communication_data_type = config.get("communication_data_type")
        comm_dtype(self.communication_data_type)
        self.disable_allgather = config.get("disable_allgather", False)
        self.checkpoint_config = CheckpointConfig(config.get("checkpoint"))
        self.activation_checkpointing_config = ActivationCheckpointingConfig(
            config.get("activation_checkpointing"))
        self.program_config = ProgramConfig(config.get("program"))
        self.attention_config = AttentionConfig(config.get("attention"))
        pld = ProgressiveLayerDropConfig(config.get("progressive_layer_drop"))
        self.pld_enabled = pld.enabled
        self.pld_params = {"theta": pld.theta, "gamma": pld.gamma}
        # taken as JAX takes them (config.py:379-386): data_efficiency is
        # stored and applied nowhere; curriculum_learning, quantize_training
        # and eigenvalue are read by the engine
        self.data_efficiency_config = dict(config.get("data_efficiency") or {})
        self.curriculum_learning_legacy = dict(config.get("curriculum_learning") or {})
        self.curriculum_enabled_legacy = bool(self.curriculum_learning_legacy.get("enabled", False))
        self.quantize_training_config = dict(config.get("quantize_training") or {})
        self.eigenvalue_config = dict(config.get("eigenvalue") or {})
        # applied by ``compression.init_compression``, as in JAX
        self.compression_config = dict(config.get("compression_training") or {})
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

        from deepspeed_tpu_torch.runtime import optimizers

        opt = config.get("optimizer")
        self.optimizer_name = opt["type"].lower() if opt and "type" in opt else None
        self.optimizer_params = dict(opt.get("params", {})) if opt else None
        self.optimizer_legacy_fusion = bool(opt.get("legacy_fusion", False)) if opt else False
        if self.optimizer_name in optimizers.ONEBIT_OPTIMIZERS:
            raise NotImplementedError(f"optimizer {opt['type']!r} belongs to a later slice of the "
                                      f"PyTorch port: the one-bit optimizers compress collectives "
                                      f"across ranks (ROADMAP.md Queue A item 8)")
        if self.optimizer_name is not None and self.optimizer_name not in optimizers.OPTIMIZER_PARAMS:
            raise ValueError(f"unknown optimizer {opt['type']!r}; the PyTorch port takes "
                             f"{sorted(optimizers.OPTIMIZER_PARAMS)}")
        if self.optimizer_legacy_fusion:
            raise NotImplementedError("optimizer.legacy_fusion: JAX's unfused optax Adam chain is "
                                      "a program-shape variant of the same update; the port has "
                                      "one Adam (FusedAdam)")
        if self.optimizer_name is not None:
            optimizers.check_optimizer_params(self.optimizer_name, self.optimizer_params or {})
        sched = config.get("scheduler")
        self.scheduler_name = sched["type"] if sched and "type" in sched else None
        self.scheduler_params = dict(sched.get("params", {})) if sched else None

        self.fp16_config = FP16Config(config.get("fp16"))
        self.fp16_enabled = self.fp16_config.enabled
        self.fp16_auto_cast = self.fp16_config.auto_cast
        self.loss_scale = self.fp16_config.loss_scale
        self.initial_dynamic_scale = 2**self.fp16_config.initial_scale_power
        self.dynamic_loss_scale_args = dict(init_scale=2**self.fp16_config.initial_scale_power,
                                            scale_window=self.fp16_config.loss_scale_window,
                                            min_scale=self.fp16_config.min_loss_scale,
                                            delayed_shift=self.fp16_config.hysteresis,
                                            consecutive_hysteresis=self.fp16_config.consecutive_hysteresis)
        bf16 = dict(config.get("bf16", config.get("bfloat16", {})))
        self.bfloat16_enabled = bool(bf16.get("enabled", False))
        if self.fp16_enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 modes cannot be simultaneously enabled")

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
