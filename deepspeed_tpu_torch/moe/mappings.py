"""Token drop/gather across the tensor-parallel axis (counterpart of
``deepspeed_tpu/moe/mappings.py``). The port runs on one device with no
tensor axis, where the JAX versions are the identity too."""

import torch


def drop_tokens(input_: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Divide the tokens on ``dim`` across the tensor-parallel ranks: one
    rank keeps them all."""
    del dim
    return input_


def gather_tokens(input_: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Re-gather tokens dropped across tensor-parallel ranks: one rank has
    them all."""
    del dim
    return input_
