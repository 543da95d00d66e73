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
    """``cuda`` (the default) or ``cpu``; a model constructor also takes
    ``meta``, a skeleton with no storage and no random init that kernel
    injection fills with the caller's tensors (``inference/engine.py``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("deepspeed_tpu_torch runs on a CUDA GPU and none is available; "
                           "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def host_to_device(array, device: torch.device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) on ``device``. To CUDA it is
    staged in pinned memory and copied without a stream sync, so a loop
    that feeds the card small index arrays between launches never waits
    for the card's queue to drain."""
    t = torch.as_tensor(array)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
