"""Compression training of the port (counterpart of
``deepspeed_tpu/compression/``): scheduled weight quantization, sparse,
row, head and channel pruning, layer reduction and knowledge distillation,
installed on an engine by ``init_compression``, and the deployment export."""

from deepspeed_tpu_torch.compression.compress import (build_compression_transform,
                                                      export_compressed, init_compression,
                                                      layer_reduction_config, load_compressed,
                                                      redundancy_clean, student_initialization)
from deepspeed_tpu_torch.compression.config import get_compression_config

__all__ = ["build_compression_transform", "export_compressed", "get_compression_config",
           "init_compression", "layer_reduction_config", "load_compressed", "redundancy_clean",
           "student_initialization"]
