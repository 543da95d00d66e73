"""The ``zero_optimization`` block (counterpart of
``deepspeed_tpu/runtime/zero/config.py``): every key, default and bound of
JAX's ``DeepSpeedZeroConfig``, ``DeepSpeedZeroOffloadParamConfig`` and
``DeepSpeedZeroOffloadOptimizerConfig``, read through the config's
``_Block`` as the other blocks are (unknown keys raise, ``"auto"`` takes the
default).

On the port's one card, stages 1, 2 and 3 partition nothing: they train
with stage 0's bits. What changes the step is offload: ``offload_optimizer``
(``cpu``: the host Adam over host masters; ``nvme``: its moments swapped to
disk) and ``offload_param`` (stage 3 only; ``cpu``: parameters rest on the
host and stream through the card block by block; ``nvme``: they also rest
in files, ``max_in_cpu`` bytes kept on the host between steps). The
bucket, prefetch and persistence knobs are taken as JAX takes them and
change nothing on one card.

Raised here, with JAX's messages: ``offload_param`` below stage 3, and
``offload_param`` with ``zero_quantized_weights``. The keys that only mean
something across ranks raise when set off their defaults
(``zero_hpz_partition_size > 1``, ``mics_shard_size > 0``,
``zero_quantized_weights``, ``zero_quantized_gradients``), naming the
multi-card slice of the port.
"""

import logging
from typing import Optional

from deepspeed_tpu_torch.runtime.config import _Block

logger = logging.getLogger(__name__)

OFFLOAD_DEVICES = ("none", "cpu", "nvme")


class DeepSpeedZeroOffloadParamConfig(_Block):
    """JAX ``DeepSpeedZeroOffloadParamConfig``."""

    NAME = "zero_optimization.offload_param"
    FIELDS = {"device": ("str", "none", OFFLOAD_DEVICES),
              "nvme_path": ("str?", None, None),
              "buffer_count": ("int", 5, 0),
              "buffer_size": ("int", 100_000_000, 0),
              "max_in_cpu": ("int", 1_000_000_000, 0),
              "pin_memory": ("bool", False, None)}


class DeepSpeedZeroOffloadOptimizerConfig(_Block):
    """JAX ``DeepSpeedZeroOffloadOptimizerConfig``."""

    NAME = "zero_optimization.offload_optimizer"
    FIELDS = {"device": ("str", "none", OFFLOAD_DEVICES),
              "nvme_path": ("str?", None, None),
              "buffer_count": ("int", 4, 0),
              "pin_memory": ("bool", False, None),
              "pipeline_read": ("bool", False, None),
              "pipeline_write": ("bool", False, None),
              "fast_init": ("bool", False, None)}

    @property
    def pipeline(self) -> bool:
        return self.pipeline_read or self.pipeline_write


def _multi_card(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} only means something across ranks; it belongs to the "
                               f"multi-card slice of the PyTorch port (ROADMAP.md Queue A item 8)")


class DeepSpeedZeroConfig(_Block):
    """JAX ``DeepSpeedZeroConfig``: the stage, the communication and stage-3
    knobs, ZeRO++ and MiCS, and the two offload blocks (None when absent)."""

    NAME = "zero_optimization"
    FIELDS = {"stage": ("int", 0, (0, 1, 2, 3)),
              "contiguous_gradients": ("bool", True, None),
              "reduce_scatter": ("bool", True, None),
              "reduce_bucket_size": ("int", 500_000_000, 0),
              "allgather_partitions": ("bool", True, None),
              "allgather_bucket_size": ("int", 500_000_000, 0),
              "overlap_comm": ("bool?", None, None),
              "load_from_fp32_weights": ("bool", True, None),
              "elastic_checkpoint": ("bool", False, None),
              "sub_group_size": ("int", 1_000_000_000, 0),
              "stage3_max_live_parameters": ("int", 1_000_000_000, 0),
              "stage3_max_reuse_distance": ("int", 1_000_000_000, 0),
              "stage3_prefetch_bucket_size": ("int", 500_000_000, 0),
              "stage3_param_persistence_threshold": ("int", 100_000, 0),
              "stage3_gather_16bit_weights_on_model_save": ("bool", False, None),
              "stage3_gather_fp16_weights_on_model_save": ("bool", False, None),
              "ignore_unused_parameters": ("bool", True, None),
              "legacy_stage1": ("bool", False, None),
              "round_robin_gradients": ("bool", False, None),
              "zero_hpz_partition_size": ("int", 1, 0),
              "zero_quantized_weights": ("bool", False, None),
              "zero_quantized_gradients": ("bool", False, None),
              "mics_shard_size": ("int", -1, None),
              "mics_hierarchical_params_gather": ("bool", False, None),
              "memory_efficient_linear": ("bool", True, None)}
    #: the two offload sub-blocks, read on their own
    OFFLOAD = {"offload_param": DeepSpeedZeroOffloadParamConfig,
               "offload_optimizer": DeepSpeedZeroOffloadOptimizerConfig}

    def __init__(self, raw: Optional[dict] = None):
        raw = dict(raw or {})
        blocks = {key: raw.pop(key, None) for key in self.OFFLOAD}
        super().__init__(raw)
        for key, cls in self.OFFLOAD.items():
            sub = blocks[key]
            if isinstance(sub, str) and sub == "auto":
                sub = None
            setattr(self, key, None if sub is None else cls(sub))
        if "stage3_gather_fp16_weights_on_model_save" in raw:
            # JAX's deprecated field forwards to its replacement unless
            # that is set too
            logger.warning("Config parameter stage3_gather_fp16_weights_on_model_save is "
                           "deprecated use stage3_gather_16bit_weights_on_model_save instead")
            if "stage3_gather_16bit_weights_on_model_save" not in raw:
                self.stage3_gather_16bit_weights_on_model_save = \
                    self.stage3_gather_fp16_weights_on_model_save
        if self.overlap_comm is None:
            self.overlap_comm = self.stage == 3
        # JAX's contract checks (``engine.py:326-333``), with its messages
        if self.offload_param_device != "none":
            if self.stage != 3:
                raise ValueError(f"offload_param requires ZeRO stage 3 (got stage {self.stage})")
            if self.zero_quantized_weights:
                raise ValueError("offload_param does not compose with zero_quantized_weights (the "
                                 "QDQ transform would run on host-resident leaves); pick one")
        if self.zero_hpz_partition_size > 1:
            raise _multi_card(f"zero_optimization.zero_hpz_partition_size="
                              f"{self.zero_hpz_partition_size} (hpZ secondary partitions)")
        if self.mics_shard_size > 0:
            raise _multi_card(f"zero_optimization.mics_shard_size={self.mics_shard_size} (MiCS)")
        for key in ("zero_quantized_weights", "zero_quantized_gradients"):
            if getattr(self, key):
                raise _multi_card(f"zero_optimization.{key} (ZeRO++ quantized collectives)")

    @property
    def offload_param_device(self) -> str:
        return "none" if self.offload_param is None else self.offload_param.device

    @property
    def offload_optimizer_device(self) -> str:
        return "none" if self.offload_optimizer is None else self.offload_optimizer.device
