"""Runtime helpers (the subset of ``deepspeed_tpu/runtime/utils.py`` the
training step uses)."""

from typing import Iterable

import torch


#: elements a sum of squares takes at once: the square's temporary stays at
#: 64 MB in fp32 however large the flat gradient buffer grows
NORM_CHUNK = 1 << 24


def global_norm_l2(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over ``tensors``, in fp32: each tensor's
    own sum of squares first (chunk by chunk of ``NORM_CHUNK`` elements,
    summed in order; one chunk for a smaller tensor), then their sum, then
    the root."""
    def sum_sq(g):
        return sum(torch.sum(c.float() * c.float()) for c in g.reshape(-1).split(NORM_CHUNK))

    return torch.sqrt(sum(sum_sq(g) for g in tensors))
