"""Elastic supervision of the port (counterpart of
``deepspeed_tpu/elasticity/``): the heartbeat file a supervised process
refreshes. The supervisor itself is a later slice (``ROADMAP.md`` Queue A)."""

from deepspeed_tpu_torch.elasticity.elastic_agent import (HEARTBEAT_ENV, read_heartbeat,
                                                          touch_heartbeat)

__all__ = ["HEARTBEAT_ENV", "read_heartbeat", "touch_heartbeat"]
