"""Topology decisions for elastic restarts (counterpart of
``deepspeed_tpu/runtime/elastic/``): what a supervisor reads off a
checkpoint's stamps. Resharding resumes wait for ``resume_elastic``."""
