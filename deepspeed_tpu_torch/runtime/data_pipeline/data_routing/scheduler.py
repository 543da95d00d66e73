"""Random-LTD reserved-length scheduler (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_routing/scheduler.py``)."""

import math
from typing import Dict

from deepspeed_tpu_torch.runtime.data_pipeline import constants as K


class RandomLTDScheduler:
    """Ramps the kept-token count from ``min_value`` to ``max_value`` over
    ``require_steps`` with ``fixed_linear`` (the only reference-supported
    type), quantized to ``seq_per_step``."""

    def __init__(self, config: Dict):
        self.model_layer_num = config[K.RANDOM_LTD_TOTAL_LAYER_NUM]
        self.random_ltd_layer_num = config[K.RANDOM_LTD_LAYER_NUM]
        self.config_schedule = config[K.RANDOM_LTD_SCHEDULER]
        self.global_batch_size = config.get(K.RANDOM_LTD_GLOBAL_BATCH_SIZE, 1)
        self.state: Dict = {}
        self.reset_to_init()

    def reset_to_init(self) -> None:
        self.state[K.RANDOM_LTD_MIN_VALUE] = self.config_schedule[K.RANDOM_LTD_MIN_VALUE]
        self.state[K.RANDOM_LTD_MAX_VALUE] = self.config_schedule[K.RANDOM_LTD_MAX_VALUE]
        self.state[K.RANDOM_LTD_CURRENT_VALUE] = self.config_schedule[K.RANDOM_LTD_MIN_VALUE]
        self.state[K.RANDOM_LTD_SCHEDULE_CONFIG] = self.config_schedule[K.RANDOM_LTD_SCHEDULE_CONFIG]
        self.state[K.RANDOM_LTD_SCHEDULER_TYPE] = self.config_schedule[K.RANDOM_LTD_SCHEDULER_TYPE]
        self.state[K.RANDOM_LTD_CONSUMED_LAYER_TOKENS] = 0
        self.state[K.RANDOM_LTD_CURR_STEP] = 0

    def get_total_layer_tokens(self, train_iters: int) -> int:
        """Layer-tokens consumed over a whole run (reference scheduler.py:60)."""
        total = 0
        for step in range(train_iters):
            total += self.get_value(step) * self.random_ltd_layer_num \
                + self.state[K.RANDOM_LTD_MAX_VALUE] * (self.model_layer_num - self.random_ltd_layer_num)
        return total * self.global_batch_size

    def _fixed_linear(self, global_steps: int) -> int:
        sconf = self.state[K.RANDOM_LTD_SCHEDULE_CONFIG]
        lo = self.state[K.RANDOM_LTD_MIN_VALUE]
        hi = self.state[K.RANDOM_LTD_MAX_VALUE]
        nxt = math.floor(float(global_steps) / sconf[K.RANDOM_LTD_REQUIRE_STEP] * (hi - lo) + lo)
        nxt -= nxt % sconf[K.RANDOM_LTD_INCREASE_STEP]
        return min(nxt, hi)

    def get_value(self, global_steps: int) -> int:
        if self.state[K.RANDOM_LTD_SCHEDULER_TYPE] == "fixed_linear":
            return self._fixed_linear(global_steps)
        raise RuntimeError(
            f"Unsupported random LTD schedule type {self.state[K.RANDOM_LTD_SCHEDULER_TYPE]!r}")

    def get_current_seq(self) -> int:
        return self.state[K.RANDOM_LTD_CURRENT_VALUE]

    def set_current_seq(self, seq_length: int) -> None:
        self.state[K.RANDOM_LTD_CURRENT_VALUE] = seq_length

    def get_random_ltd_layer_num(self) -> int:
        return self.random_ltd_layer_num

    def update_seq(self, global_steps: int) -> int:
        if self.state[K.RANDOM_LTD_CURRENT_VALUE] < self.state[K.RANDOM_LTD_MAX_VALUE]:
            self.state[K.RANDOM_LTD_CURRENT_VALUE] = self.get_value(global_steps)
        if global_steps != self.state[K.RANDOM_LTD_CURR_STEP]:
            self.state[K.RANDOM_LTD_CONSUMED_LAYER_TOKENS] += self.global_batch_size * (
                self.state[K.RANDOM_LTD_CURRENT_VALUE] * self.random_ltd_layer_num
                + self.state[K.RANDOM_LTD_MAX_VALUE] * (self.model_layer_num - self.random_ltd_layer_num))
            self.state[K.RANDOM_LTD_CURR_STEP] = global_steps
        return self.state[K.RANDOM_LTD_CURRENT_VALUE]

    def state_dict(self) -> Dict:
        return {k: self.state[k] for k in
                (K.RANDOM_LTD_CONSUMED_LAYER_TOKENS, K.RANDOM_LTD_CURR_STEP,
                 K.RANDOM_LTD_CURRENT_VALUE, K.RANDOM_LTD_MIN_VALUE, K.RANDOM_LTD_MAX_VALUE)}

    def load_state_dict(self, state_dict: Dict) -> None:
        for k in (K.RANDOM_LTD_CONSUMED_LAYER_TOKENS, K.RANDOM_LTD_CURR_STEP,
                  K.RANDOM_LTD_CURRENT_VALUE, K.RANDOM_LTD_MIN_VALUE, K.RANDOM_LTD_MAX_VALUE):
            self.state[k] = state_dict[k]
