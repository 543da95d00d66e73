"""Top Hessian eigenvalue per layer (counterpart of
``deepspeed_tpu/runtime/eigenvalue.py``): power iteration on the
Hessian-vector product, which MoQ uses to anneal high-curvature layers
slower.

The HVP is reverse over reverse, as in the reference: the gradient is taken
with ``create_graph=True`` once, and each iteration differentiates it
against the current vector. It needs every op of the loss to be twice
differentiable: the hand-written kernels' ``autograd.Function``\\ s are not
(a second derivative through them raises, as it does through JAX's
``custom_vjp``\\ s), so the probe runs on the ``"xla"`` attention backend
without the fused head. Parameters are a flat ``{name: tensor}`` dict; a
layer is every name under the prefix ``f"{layer_name}_{i}."`` (GPT-2's
``h_0`` ... ``h_{n-1}``). The random start vectors come from a
``torch.Generator``; ``init_vectors`` injects them.
"""

import logging
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

logger = logging.getLogger(__name__)


def _dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> float:
    return float(sum((x.float() * y.float()).sum() for x, y in zip(a, b)))


def power_iteration(loss_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                    sub: Dict[str, torch.Tensor], max_iter: int = 100, tol: float = 1e-2,
                    stability: float = 1e-6, generator: Optional[torch.Generator] = None,
                    init_vector: Optional[Sequence[torch.Tensor]] = None) -> float:
    """Top eigenvalue of the Hessian of ``loss_fn`` with respect to the
    tensors of ``sub``, by power iteration on the HVP (JAX's loop and stop
    rule). ``init_vector`` (a tensor per entry of ``sub``: a dict by name,
    or a sequence in ``sub``'s order) replaces the random start."""
    names = list(sub)
    # a leaf that requires grad (a module's parameter) is differentiated as
    # it is: a loss that reads the module, remat's recompute included, needs
    # that very tensor; anything else gets a fresh leaf
    leaves = [t if t.is_leaf and t.requires_grad else t.detach().requires_grad_(True)
              for t in (sub[n] for n in names)]
    loss = loss_fn(dict(zip(names, leaves)))
    # a tensor the loss does not use has a zero gradient and Hessian block
    grads = (torch.autograd.grad(loss, leaves, create_graph=True, allow_unused=True)
             if loss.requires_grad else [None] * len(leaves))
    live = [i for i, g in enumerate(grads) if g is not None and g.requires_grad]

    def hvp(v):
        out = [torch.zeros_like(x) for x in leaves]
        if live:
            got = torch.autograd.grad([grads[i] for i in live], leaves,
                                      grad_outputs=[v[i] for i in live], retain_graph=True,
                                      allow_unused=True)
            out = [o if g is None else g for o, g in zip(out, got)]
        return out

    def normalize(v):
        norm = math.sqrt(sum(float(x.float().square().sum()) for x in v)) + stability
        return [torch.nan_to_num(x / norm, posinf=0.0, neginf=0.0) for x in v]

    if init_vector is None:
        init_vector = [torch.randn(x.shape, generator=generator, dtype=torch.float32,
                                   device=generator.device if generator is not None else x.device)
                       for x in leaves]
    if isinstance(init_vector, dict):
        init_vector = [init_vector[n] for n in names]
    v = normalize([torch.as_tensor(t).to(device=x.device, dtype=x.dtype)
                   for t, x in zip(init_vector, leaves)])
    eig = 0.0
    with torch.no_grad():
        for it in range(max_iter):
            with torch.enable_grad():
                hv = hvp(v)
            new_eig = _dot(v, hv)
            v = normalize(hv)
            if abs(new_eig) < 1e-12:
                return new_eig
            if it > 0 and abs(new_eig - eig) / (abs(new_eig) + 1e-12) < tol:
                return new_eig
            eig = new_eig
    return eig


class Eigenvalue:

    def __init__(self, verbose: bool = False, max_iter: int = 100, tol: float = 1e-2,
                 stability: float = 1e-6, gas_boundary_resolution: int = 1, layer_name: str = "",
                 layer_num: int = 0):
        assert layer_name and layer_num > 0
        self.verbose = verbose
        self.max_iter = max_iter
        self.tol = tol
        self.stability = stability
        self.gas_boundary_resolution = gas_boundary_resolution
        self.layer_name = layer_name
        self.layer_num = layer_num
        logger.info(f"enabled eigenvalue with max_iter={max_iter}, tol={tol}, "
                    f"layer_name={layer_name}, layer_num={layer_num}")

    def _layer_keys(self, params: Dict[str, torch.Tensor]) -> List[str]:
        keys = [f"{self.layer_name}_{i}" for i in range(self.layer_num)]
        tops = {n.split(".", 1)[0] for n in params}
        missing = [k for k in keys if k not in tops]
        if missing:
            raise KeyError(f"eigenvalue layer subtrees not found: {missing}; "
                           f"available: {sorted(tops)}")
        return keys

    def _layer_eigenvalue(self, loss_fn, params, key: str, generator, init_vector) -> float:
        """Top eigenvalue of d2L/dp2 restricted to the layer ``key``."""
        sub = {n: p for n, p in params.items() if n.startswith(key + ".")}
        eig = power_iteration(lambda s: loss_fn({**params, **s}), sub, max_iter=self.max_iter,
                              tol=self.tol, stability=self.stability, generator=generator,
                              init_vector=init_vector)
        if self.verbose:
            logger.info(f"eigenvalue[{key}] = {eig:.6g}")
        return eig

    def compute_eigenvalue(self, loss_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                           params: Dict[str, torch.Tensor],
                           generator: Optional[torch.Generator] = None, scrub: bool = True,
                           init_vectors: Optional[Sequence] = None
                           ) -> List[float]:
        """Per-layer top eigenvalues (absolute). With ``scrub`` (JAX's
        default): non-finite values become zeros, and zeros the max.
        ``init_vectors[i]`` injects layer i's start vector."""
        keys = self._layer_keys(params)
        eigs = [abs(self._layer_eigenvalue(loss_fn, params, k, generator,
                                           None if init_vectors is None else init_vectors[i]))
                for i, k in enumerate(keys)]
        if not scrub:
            return eigs
        eigs = [e if math.isfinite(e) else 0.0 for e in eigs]
        max_eig = max(eigs) if any(e > 0 for e in eigs) else 1.0
        return [e if e > 0 else max_eig for e in eigs]


def hessian_top_eigenvalue(loss_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                           params: Dict[str, torch.Tensor], max_iter: int = 50, tol: float = 1e-3,
                           generator: Optional[torch.Generator] = None,
                           init_vector: Optional[Sequence[torch.Tensor]] = None) -> float:
    """The top Hessian eigenvalue over all of ``params``."""
    return power_iteration(loss_fn, params, max_iter=max_iter, tol=tol, generator=generator,
                           init_vector=init_vector)
