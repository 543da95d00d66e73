"""Progressive Layer Dropping (counterpart of
``deepspeed_tpu/runtime/progressive_layer_drop.py``, arXiv:2010.13369).

The host schedule ``theta(t) = (1 - theta) * exp(-gamma * t) + theta``: the
expected keep ratio anneals from 1.0 toward ``theta``. The engine updates it
at each step and hands ``pld_theta`` to a model that takes it
(``GPT2Config.progressive_layer_drop``), which keeps block i's sublayers
with probability ``1 - (i + 1) / n_layer * (1 - theta)``.
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)


class ProgressiveLayerDrop:

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        logger.info(f"Enabled progressive layer dropping (theta = {self.theta})")

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step: int):
        self.current_theta = (1.0 - self.theta) * float(np.exp(-self.gamma * global_step)) + self.theta
