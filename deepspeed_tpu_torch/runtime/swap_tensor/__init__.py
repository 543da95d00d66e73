"""NVMe swapping of optimizer state (counterpart of
``deepspeed_tpu/runtime/swap_tensor``)."""

from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import NVMeAdam, PipelinedOptimizerSwapper

__all__ = ["NVMeAdam", "PipelinedOptimizerSwapper"]
