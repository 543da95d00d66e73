"""DeepSpeedCPUAdam and DeepSpeedCPUAdagrad: the host optimizers of
ZeRO-Offload (counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py``).

The GPU computes the gradients; the fp32 master parameters and the moments
live in host RAM and are updated in place by the AVX2 C++ kernel
``csrc/host/cpu_adam.cpp``, leaf by leaf (a large leaf split across the
host's cores, where the JAX package's runs on one).
Operands are CPU tensors or numpy arrays, fp32 and contiguous; a CPU tensor
is updated through a numpy view of its memory. The moments are numpy arrays
keyed by the leaf's stable index.
"""

import ctypes
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from deepspeed_tpu_torch.ops.op_builder import CPUAdamBuilder

HostArray = Union[np.ndarray, torch.Tensor]


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def host_view(x: HostArray, what: str = "operand") -> np.ndarray:
    """``x`` as a numpy array sharing its memory: a CPU tensor's view, or
    the array itself."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{what} must live on the host, got a tensor on {x.device}")
        return x.detach().numpy()
    return x


class DeepSpeedCPUAdam:
    """Adam/AdamW over host masters (JAX ``DeepSpeedCPUAdam``). As there,
    ``model_params`` is taken for upstream's signature and not used: the
    caller passes the (master, grad) pairs to ``step`` or, inside a
    ``begin_step`` window, one pair at a time to ``step_single``."""

    def __init__(self, model_params=None, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, bias_correction: bool = True,
                 adamw_mode: bool = True, fp32_optimizer_states: bool = True):
        del model_params, fp32_optimizer_states
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.adamw_mode = adamw_mode
        self.lib = CPUAdamBuilder().load()
        self.state: Dict[int, Dict[str, np.ndarray]] = {}
        self.step_count = 0
        self._step_lr = lr

    def ensure_state(self, idx: int, n: int) -> Dict[str, np.ndarray]:
        """Leaf ``idx``'s moments ``{"m", "v"}`` (fp32 ``[n]``), zeros when
        new."""
        if idx not in self.state:
            self.state[idx] = {"m": np.zeros(n, np.float32), "v": np.zeros(n, np.float32)}
        return self.state[idx]

    def begin_step(self, lr: Optional[float] = None) -> None:
        """Open one optimizer step for per-leaf ``step_single`` calls."""
        self.step_count += 1
        self._step_lr = self.lr if lr is None else lr

    def step_single(self, idx: int, param: HostArray, grad: HostArray,
                    bf16_out: Optional[HostArray] = None) -> None:
        """Update one (master, grad) pair inside a ``begin_step`` window.
        ``idx`` keys the moments: the leaf's stable position. The ctypes
        call releases the GIL. ``bf16_out`` (uint16 or bfloat16, the
        master's size) receives the updated master rounded to bf16."""
        p = host_view(param, "the master")
        if p.dtype != np.float32 or not p.flags.c_contiguous:
            raise ValueError(f"the host master must be fp32 and contiguous, got {p.dtype}")
        g32 = np.ascontiguousarray(host_view(grad, "the gradient").reshape(-1), np.float32)
        flat = p.reshape(-1)
        st = self.ensure_state(idx, flat.size)
        args = (flat.size, self.step_count, self._step_lr, self.betas[0], self.betas[1], self.eps,
                self.weight_decay, int(self.adamw_mode), int(self.bias_correction))
        if bf16_out is not None:
            if isinstance(bf16_out, torch.Tensor):
                bf16_out = bf16_out.view(torch.int16) if bf16_out.dtype == torch.bfloat16 else bf16_out
            out = host_view(bf16_out, "bf16_out").reshape(-1)
            self.lib.ds_adam_update_copy_bf16(
                _f32p(flat), _f32p(g32), _f32p(st["m"]), _f32p(st["v"]),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), *args)
        else:
            self.lib.ds_adam_update(_f32p(flat), _f32p(g32), _f32p(st["m"]), _f32p(st["v"]), *args)

    def step(self, params: List[HostArray], grads: List[HostArray],
             bf16_out: Optional[List[HostArray]] = None, lr: Optional[float] = None):
        """One step over every (master, grad) pair, in place; leaf ``i``'s
        moments are ``state[i]``."""
        self.begin_step(lr)
        for i, (p, g) in enumerate(zip(params, grads)):
            self.step_single(i, p, g, None if bf16_out is None else bf16_out[i])
        return params

    # -- checkpoint surface (JAX's format) ------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step_count,
                "state": {str(k): {"m": v["m"], "v": v["v"]} for k, v in self.state.items()}}

    def load_state_dict(self, sd: dict) -> None:
        """Take the step and copies of the moments of ``sd``."""
        self.step_count = int(sd["step"])
        self.state = {int(k): {"m": np.array(host_view(v["m"]), np.float32).reshape(-1),
                               "v": np.array(host_view(v["v"]), np.float32).reshape(-1)}
                      for k, v in sd["state"].items()}

    def reset_state(self) -> None:
        self.step_count = 0
        self.state = {}


class DeepSpeedCPUAdagrad:
    """Adagrad over host arrays (JAX ``DeepSpeedCPUAdagrad``; upstream
    ``ops/adagrad/cpu_adagrad.py``)."""

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.lib = CPUAdamBuilder().load()
        self.state: Dict[int, np.ndarray] = {}

    def step(self, params: List[HostArray], grads: List[HostArray], lr: Optional[float] = None):
        use_lr = self.lr if lr is None else lr
        for i, (p, g) in enumerate(zip(params, grads)):
            flat = host_view(p, "the parameter").reshape(-1)
            if flat.dtype != np.float32:
                raise ValueError(f"the host parameter must be fp32, got {flat.dtype}")
            if i not in self.state:
                self.state[i] = np.zeros(flat.size, np.float32)
            g32 = np.ascontiguousarray(host_view(g, "the gradient").reshape(-1), np.float32)
            self.lib.ds_adagrad_update(_f32p(flat), _f32p(g32), _f32p(self.state[i]), flat.size,
                                       use_lr, self.eps, self.weight_decay)
        return params
