"""Route and kernel selection for the MoE dispatch/combine (counterpart of
``deepspeed_tpu/moe/routing.py``, kept as the port's own copy).

The MoE layer has two equivalent dispatch/combine formulations
(``sharded_moe.MOELayer``):

* ``dense``: the GShard einsum route (``sec,sm->ecm`` over a one-hot mask),
  which builds a ``[G,S,E,C]`` combine-weights tensor and pays
  O(S*E*C*M) FLOPs and bytes in forward and backward for a gather of at
  most k*S rows;
* ``sorted``: the token-permutation route. Each token copy carries a flat
  destination slot ``expert*C + position``; the ``[E*C, M]`` dispatch
  buffer is built by a row permutation, the experts run on it, and the
  combine is a gather plus a k-way weighted sum. No ``[G,S,E,C]`` tensor
  exists in either pass.

Which one runs resolves through layers, highest precedence first:

1. an explicit per-layer kwarg (``MOELayer(route=...)``, the model config's
   ``moe_route``);
2. the ``DS_MOE_ROUTE`` environment variable;
3. the engine's ``"moe"`` config block (:func:`set_default_route`, applied
   by ``runtime/engine.py``);
4. the default, ``"sorted"``.

``kernel`` picks the sorted route's permutation: ``"xla"`` (the plain
PyTorch gather), ``"pallas"`` (K5, ``ops/cuda/moe_dispatch.py``; the JAX
name is kept so configs carry over) or ``"auto"`` (K5). Layers: kwarg >
``DS_MOE_KERNEL`` > config block > ``"auto"``.

This module imports no tensor library: the engine consults it without
touching kernel code.
"""

import os
import threading
from typing import Optional, Tuple

ENV_ROUTE = "DS_MOE_ROUTE"
ENV_KERNEL = "DS_MOE_KERNEL"

ROUTE_CHOICES = ("dense", "sorted")
KERNEL_CHOICES = ("auto", "xla", "pallas")

DEFAULT_ROUTE = "sorted"
DEFAULT_KERNEL = "auto"

_lock = threading.Lock()
_config_route: Optional[str] = None
_config_kernel: Optional[str] = None


def _check(value: Optional[str], choices, what: str) -> Optional[str]:
    if value is not None and value not in choices:
        raise ValueError(f"moe {what} must be one of {choices}, got {value!r}")
    return value


def set_default_route(route: Optional[str], kernel: Optional[str] = None) -> None:
    """Install the engine-level default route and kernel (None clears: an
    engine whose config has no ``"moe"`` block must not inherit a previous
    engine's install)."""
    global _config_route, _config_kernel
    with _lock:
        _config_route = _check(route, ROUTE_CHOICES, "route")
        _config_kernel = _check(kernel, KERNEL_CHOICES, "kernel")


def get_default_route() -> Tuple[Optional[str], Optional[str]]:
    return _config_route, _config_kernel


def resolve_route(route: Optional[str] = None,
                  kernel: Optional[str] = None) -> Tuple[str, str, str]:
    """Resolve ``(route, kernel, source)`` for one MoE layer call.
    ``source`` names the layer that decided the route ("explicit" > "env" >
    "config" > "default")."""
    src = "default"
    r = DEFAULT_ROUTE
    if _config_route is not None:
        r, src = _config_route, "config"
    env_r = os.environ.get(ENV_ROUTE, "").strip() or None
    if env_r is not None:
        r, src = _check(env_r, ROUTE_CHOICES, f"route (from {ENV_ROUTE})"), "env"
    if route is not None:
        r, src = _check(route, ROUTE_CHOICES, "route"), "explicit"

    k = DEFAULT_KERNEL
    if _config_kernel is not None:
        k = _config_kernel
    env_k = os.environ.get(ENV_KERNEL, "").strip() or None
    if env_k is not None:
        k = _check(env_k, KERNEL_CHOICES, f"kernel (from {ENV_KERNEL})")
    if kernel is not None:
        k = _check(kernel, KERNEL_CHOICES, "kernel")
    return r, k, src


def resolve_intended_route(route: Optional[str] = None) -> str:
    """The route the committed configuration intends, skipping the
    environment layer (a ``DS_MOE_ROUTE`` override changes what runs, not
    what the configuration declares)."""
    if route is not None:
        return _check(route, ROUTE_CHOICES, "route")
    if _config_route is not None:
        return _config_route
    return DEFAULT_ROUTE
