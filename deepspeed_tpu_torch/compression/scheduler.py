"""Compression scheduling (counterpart of
``deepspeed_tpu/compression/scheduler.py``; upstream
``compression_scheduler``). The engine gates each technique on its own step
count; this class keeps upstream's host-side surface for training loops
that call it: ``step()``, ``training_steps``, ``is_active`` and the flags
and log lines set the first time a technique's offset is crossed."""

import logging
from typing import Any, Dict

from deepspeed_tpu_torch.compression.config import (ACTIVATION_QUANTIZATION, CHANNEL_PRUNING,
                                                    HEAD_PRUNING, ROW_PRUNING, SHARED_PARAMETERS,
                                                    SPARSE_PRUNING, WEIGHT_QUANTIZATION,
                                                    get_compression_config)

logger = logging.getLogger(__name__)

_TECHNIQUES = (WEIGHT_QUANTIZATION, SPARSE_PRUNING, HEAD_PRUNING, ROW_PRUNING, CHANNEL_PRUNING)


class compression_scheduler:
    """Tracks ``training_steps`` and reports which techniques are active.
    ``model`` is held for upstream's signature only: activation follows the
    config's offsets."""

    def __init__(self, model, compression_config: Dict[str, Any]):
        self.model = model
        # a raw ds_config, or a block get_compression_config already resolved
        if WEIGHT_QUANTIZATION not in compression_config:
            compression_config = get_compression_config(compression_config)
        self.compression_config = compression_config
        self.training_steps = 0
        self.weight_quantization_enabled = False
        self.verbose = {t: False for t in _TECHNIQUES}
        self.verbose[ACTIVATION_QUANTIZATION] = False

    def _offset(self, tech: str) -> int:
        return int(self.compression_config[tech][SHARED_PARAMETERS].get("schedule_offset", 0))

    def _enabled(self, tech: str) -> bool:
        return bool(self.compression_config[tech][SHARED_PARAMETERS].get("enabled", False))

    def is_active(self, tech: str) -> bool:
        return self._enabled(tech) and self.training_steps >= self._offset(tech)

    def _check(self, tech: str):
        if not self._enabled(tech):
            return
        if self.training_steps >= self._offset(tech) and not self.verbose[tech]:
            logger.info(f"{tech} is enabled at step {self.training_steps}")
            self.verbose[tech] = True
            if tech == WEIGHT_QUANTIZATION:
                self.weight_quantization_enabled = True

    def check_weight_quantization(self):
        self._check(WEIGHT_QUANTIZATION)

    def check_activation_quantization(self):
        # not a weight transform: a model applies quantize_activation itself
        pass

    def check_sparse_pruning(self):
        self._check(SPARSE_PRUNING)

    def check_head_pruning(self):
        self._check(HEAD_PRUNING)

    def check_row_pruning(self):
        self._check(ROW_PRUNING)

    def check_channel_pruning(self):
        self._check(CHANNEL_PRUNING)

    def check_all_modules(self):
        for tech in _TECHNIQUES:
            self._check(tech)

    def step(self, step_zero_check: bool = False):
        """Advance the step count, then check every technique's gate."""
        if not step_zero_check:
            self.training_steps += 1
        self.check_all_modules()
