"""Fault tolerance for the port's training engine (counterpart of
``deepspeed_tpu/runtime/resilience/``):

* :mod:`manifest`: file inventories and per-leaf digests that make a
  checkpoint verifiable; staging and atomic publish that make it
  crash-consistent;
* :mod:`signals`: :class:`PreemptionGuard`, SIGTERM/SIGINT turned into a
  checkpoint at the next step boundary;
* :mod:`retry`: exponential backoff with jitter and a per-attempt evidence
  log;
* :mod:`faults`: deterministic fault injection by class (SIGKILL at a step
  boundary, torn saves, damaged files, poisoned gradients, transient 500s).
"""

from deepspeed_tpu_torch.runtime.resilience.manifest import (MANIFEST_NAME, CheckpointCorruptError,
                                                             atomic_publish, build_manifest,
                                                             list_checkpoint_tags, read_manifest,
                                                             verify_checkpoint_dir,
                                                             verify_state_leaves, write_atomic_text)
from deepspeed_tpu_torch.runtime.resilience.retry import (RetryPolicy, classify_failure,
                                                          is_transient)
from deepspeed_tpu_torch.runtime.resilience.signals import PreemptionGuard

__all__ = ["MANIFEST_NAME", "CheckpointCorruptError", "atomic_publish", "build_manifest",
           "list_checkpoint_tags", "read_manifest", "verify_checkpoint_dir",
           "verify_state_leaves", "write_atomic_text", "RetryPolicy", "classify_failure",
           "is_transient", "PreemptionGuard"]
