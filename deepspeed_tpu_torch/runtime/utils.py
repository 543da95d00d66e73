"""Runtime helpers (the subset of ``deepspeed_tpu/runtime/utils.py`` the
training step uses)."""

from typing import Iterable

import torch


def global_norm_l2(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over ``tensors``, in fp32: each tensor's
    own sum of squares first, then their sum, then the root."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in tensors))
