"""Compression of the port (counterpart of ``deepspeed_tpu/compression/``):
only the layer-reduced student's initialisation, the speculation
drafter's constructor. The rest of compression training is not ported."""

from deepspeed_tpu_torch.compression.compress import (layer_reduction_config,
                                                      student_initialization)

__all__ = ["layer_reduction_config", "student_initialization"]
