"""The serving fleet (counterpart of ``deepspeed_tpu/inference/fleet/``):
several continuous-batching schedulers behind one request stream.

* :mod:`protocol`: the line-delimited JSON the workers speak.
* :mod:`replica`: replica handles, in process (:class:`LocalReplica`) and
  subprocess (:class:`SubprocessReplica`: real pipes, heartbeat liveness).
* :mod:`router`: :class:`FleetRouter`, least-loaded dispatch from the
  replicas' own tick signals, at-most-once completion accounting, recovery
  from a replica's death (bundle re-admission, re-dispatch).
* :mod:`autoscaler`: :class:`Autoscaler`, hysteretic replica-count decisions
  from the same signals, replayable offline.
* :mod:`migrate`: live KV migration over the checkpoint manifest (save,
  load and verify bundles, restore into a scheduler).
* :mod:`worker`: ``python -m deepspeed_tpu_torch.inference.fleet.worker``.
"""

from deepspeed_tpu_torch.inference.fleet.autoscaler import AutoscalePolicy, Autoscaler
from deepspeed_tpu_torch.inference.fleet.migrate import (load_bundle, make_bundle_migrate,
                                                         receive_bundle, restore_into,
                                                         save_bundle)
from deepspeed_tpu_torch.inference.fleet.replica import LocalReplica, SubprocessReplica
from deepspeed_tpu_torch.inference.fleet.router import FleetRouter

__all__ = ["AutoscalePolicy", "Autoscaler", "FleetRouter", "LocalReplica",
           "SubprocessReplica", "load_bundle", "make_bundle_migrate",
           "receive_bundle", "restore_into", "save_bundle"]
