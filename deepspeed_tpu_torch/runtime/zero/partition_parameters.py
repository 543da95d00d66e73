"""``zero.Init``, ``GatheredParameters`` and the external-parameter
registry at one rank (counterpart of
``deepspeed_tpu/runtime/zero/partition_parameters.py``, after upstream's).

Upstream must intercept module construction because ZeRO-3 partitions
every parameter across ranks and gathers it around each use. On the port's
one card nothing is partitioned: a parameter is a whole tensor (on the card,
or resting on the host under ``offload_param``), so these are as thin as
the JAX package's, and stage-3 user code written against upstream runs
unchanged: ``Init`` records its knobs and carries a config for
``initialize``, ``GatheredParameters`` yields the parameters themselves (an
in-place write inside it changes the live tensor), and registering an
external parameter has no hook to tell.
"""

import contextlib
import enum
import logging
from typing import Optional

logger = logging.getLogger(__name__)

_ACTIVE_INIT: Optional["Init"] = None


def get_active_init() -> Optional["Init"]:
    """The innermost active ``zero.Init`` context; ``initialize`` reads a
    config it carries (``Init(config_dict_or_path=...)``) when given none."""
    return _ACTIVE_INIT


class ZeroParamStatus(enum.Enum):
    """Upstream's parameter states. At one rank a parameter is always
    AVAILABLE; the others are kept for import parity."""
    AVAILABLE = 1
    NOT_AVAILABLE = 2
    INFLIGHT = 3


class Init:
    """``with zero.Init(...):`` with upstream's arguments. The knobs are
    recorded; ``module=`` and the partitioning ones have nothing to act on
    at one rank (a model of the port is built with ``device=`` and moved to
    its resting place by the engine under ``offload_param``)."""

    def __init__(self, module=None, data_parallel_group=None, mem_efficient_linear=True,
                 remote_device: Optional[str] = None, device: Optional[str] = None,
                 pin_memory: bool = False, config_dict_or_path=None, config=None,
                 enabled: bool = True, dtype=None, mpu=None):
        self.enabled = enabled
        self.dtype = dtype
        self.remote_device = remote_device or device
        self.pin_memory = pin_memory
        self.config = config_dict_or_path if config_dict_or_path is not None else config
        self._prev: Optional[Init] = None
        if module is not None:
            logger.warning("zero.Init(module=...) partitions nothing at one rank; pass the "
                           "module to deepspeed_tpu_torch.initialize as usual")

    def __enter__(self):
        global _ACTIVE_INIT
        if self.enabled:
            self._prev = _ACTIVE_INIT
            _ACTIVE_INIT = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE_INIT
        if self.enabled:
            _ACTIVE_INIT = self._prev
        return False


@contextlib.contextmanager
def GatheredParameters(params, modifier_rank: Optional[int] = None, fwd_module=None,
                       enabled: bool = True):
    """``with zero.GatheredParameters(params):`` yields ``params`` (a
    parameter, a list of them, or None): at one rank they are whole already.
    Writes in place reach the live parameters; under ``offload_optimizer``
    the host masters are separate and are not rewritten here."""
    yield params


def register_external_parameter(module, parameter) -> None:
    """Upstream tells ZeRO-3's gather hooks that ``module`` uses a parameter
    it does not own; at one rank there is no hook to tell."""
    return None


def unregister_external_parameter(module, parameter) -> None:
    return None
