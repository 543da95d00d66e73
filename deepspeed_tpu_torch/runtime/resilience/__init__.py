"""Checkpoint integrity for the port's training engine (counterpart of
``deepspeed_tpu/runtime/resilience/``): manifests, staging and atomic
publish."""
