"""In-flight RLHF rollouts on the continuous scheduler (counterpart of
``deepspeed_tpu/runtime/rlhf``): the rollout loop and the weight sync."""

from deepspeed_tpu_torch.runtime.rlhf.rollout import Experience, RolloutConfig, RolloutLoop
from deepspeed_tpu_torch.runtime.rlhf.sync import (execute_params_sync, params_digest,
                                                   plan_params_sync)

__all__ = ["Experience", "RolloutConfig", "RolloutLoop", "execute_params_sync", "params_digest",
           "plan_params_sync"]
