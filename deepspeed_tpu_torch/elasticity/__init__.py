"""Elastic training of the port (counterpart of ``deepspeed_tpu/elasticity/``):
the restart supervisor ``DSElasticAgent``, the heartbeat a supervised
process refreshes, and the elastic batch arithmetic."""

from deepspeed_tpu_torch.elasticity.elastic_agent import (HEARTBEAT_ENV, RESTART_ENV, WORLD_ENV,
                                                          DSElasticAgent, heartbeat_age,
                                                          read_heartbeat, touch_heartbeat)
from deepspeed_tpu_torch.elasticity.elasticity import (ElasticityConfig, ElasticityConfigError,
                                                       ElasticityError,
                                                       ElasticityIncompatibleWorldSize,
                                                       compute_elastic_config, elasticity_enabled)

__all__ = ["compute_elastic_config", "elasticity_enabled", "ElasticityConfig", "ElasticityError",
           "ElasticityConfigError", "ElasticityIncompatibleWorldSize", "DSElasticAgent",
           "touch_heartbeat", "read_heartbeat", "heartbeat_age", "HEARTBEAT_ENV", "WORLD_ENV",
           "RESTART_ENV"]
