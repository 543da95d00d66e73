"""Checkpoint backends of the port's training engine (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/``)."""
