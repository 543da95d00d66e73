"""Device resolution for the port's entry points.

The port runs on an NVIDIA GPU. An entry point takes ``device=None``
(meaning ``cuda``) or an explicit device; the CPU runs only when asked for
by name (``device="cpu"``, as the tests do), and there the kernel wrappers
use their plain PyTorch versions. A missing GPU is an error, never a quiet
move to the CPU."""

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("deepspeed_tpu_torch runs on a CUDA GPU and none is available; "
                           "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
