"""Pluggable checkpoint backend (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``, after
upstream ``CheckpointEngine``): save and load by tag."""


class CheckpointEngine:

    def save(self, state, tag, metadata=None):
        raise NotImplementedError

    def load(self, state, tag, **kwargs):
        raise NotImplementedError
