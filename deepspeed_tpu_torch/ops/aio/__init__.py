"""Async file I/O for NVMe offload (counterpart of ``deepspeed_tpu/ops/aio``)."""

from deepspeed_tpu_torch.ops.aio.aio_handle import AsyncIOHandle

__all__ = ["AsyncIOHandle"]
