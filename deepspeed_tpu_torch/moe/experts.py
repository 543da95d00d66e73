"""Experts container (counterpart of ``deepspeed_tpu/moe/experts.py``); the
implementation lives in ``sharded_moe.Experts``."""

from deepspeed_tpu_torch.moe.sharded_moe import Experts

__all__ = ["Experts"]
