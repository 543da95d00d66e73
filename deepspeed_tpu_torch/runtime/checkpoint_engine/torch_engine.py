"""The port's checkpoint backend (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/orbax_engine.py``, after upstream
``TorchCheckpointEngine``).

A state is a flat ``{"<group>/<name>": tensor}`` dict of the live tensors
(``DeepSpeedEngine.checkpoint_state``): group ``module`` the parameters,
``optimizer`` the optimizer state, any other group (the engine's ``rng``)
state that travels with the counters. A tag is a directory::

    <tag>/state/<group>.pt   one torch.save'd {name: tensor} per group
    <tag>/metadata.json      the engine's counters and client_state (JSON)
    <tag>/manifest.json      file inventory and per-leaf digests

``save`` copies each tensor to the host once, hashes that copy and writes
it into the staging dir ``.tmp.<tag>``, then writes the manifest, fsyncs
and renames the dir into place (``runtime/resilience/manifest.py``): the
save is synchronous, and until the rename the tag is invisible.
``load`` verifies the file inventory before it deserializes anything
(``torch.load(weights_only=True)``: tensors and plain containers only,
nothing arbitrary is unpickled), re-hashes every deserialized leaf under
``verify="full"``, and only then copies into the live tensors in place, so
a corrupt tag never reaches them and no tensor object is replaced.
"""

import json
import logging
import os
import pickle
import shutil
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import CheckpointEngine
from deepspeed_tpu_torch.runtime.config import VERIFY_CHECKPOINT_MODES
from deepspeed_tpu_torch.runtime.resilience import manifest as ckpt_manifest
from deepspeed_tpu_torch.runtime.resilience.manifest import CheckpointCorruptError

logger = logging.getLogger(__name__)

STATE_DIR = "state"
METADATA_NAME = "metadata.json"
MODULE_GROUP = "module"
OPTIMIZER_GROUP = "optimizer"


def _group(name: str) -> str:
    return name.split("/", 1)[0]


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host in a storage of its own (``torch.save`` writes a
    view's whole storage)."""
    host = t.detach().cpu()
    if not host.is_contiguous() or host.untyped_storage().nbytes() != host.nbytes:
        host = host.contiguous().clone()
    return host


class TorchCheckpointEngine(CheckpointEngine):

    def __init__(self, base_dir: str):
        self.base_dir = os.path.abspath(base_dir)

    def _path(self, tag) -> str:
        return os.path.join(self.base_dir, str(tag))

    def save(self, state: Dict[str, torch.Tensor], tag, metadata: Optional[dict] = None) -> None:
        """Write ``tag`` and publish it atomically; when this returns the
        tag is complete and verifiable. ``metadata`` must be JSON."""
        tag = str(tag)
        meta_text = json.dumps(metadata) if metadata is not None else None
        staging = ckpt_manifest.staging_path(self.base_dir, tag)
        os.makedirs(self.base_dir, exist_ok=True)
        ckpt_manifest.sweep_stale_staging(self.base_dir)
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(os.path.join(staging, STATE_DIR))
        host = {name: _host_copy(t) for name, t in state.items()}
        leaves = ckpt_manifest.state_leaf_entries(host)
        for group in sorted({_group(k) for k in host}):
            torch.save({k: v for k, v in host.items() if _group(k) == group},
                       os.path.join(staging, STATE_DIR, f"{group}.pt"))
        if meta_text is not None:
            with open(os.path.join(staging, METADATA_NAME), "w") as f:
                f.write(meta_text)
        ckpt_manifest.write_manifest(staging, ckpt_manifest.build_manifest(staging,
                                                                           leaf_entries=leaves))
        ckpt_manifest.atomic_publish(staging, self._path(tag))
        logger.info(f"published checkpoint {tag} -> {self._path(tag)}")

    def load(self, state: Dict[str, torch.Tensor], tag, load_optimizer_states: bool = True,
             load_module_only: bool = False, verify: str = "full") -> dict:
        """Restore ``tag`` into ``state``'s tensors in place and return the
        tag's metadata. ``verify``: "off", "files" (the inventory before
        deserializing) or "full" (and every leaf's digest after).
        ``load_module_only`` copies the module group alone,
        ``load_optimizer_states=False`` every group but the optimizer's.
        Raises :class:`CheckpointCorruptError` on any integrity failure and
        ``ValueError`` when the tag holds another model's state."""
        if verify not in VERIFY_CHECKPOINT_MODES:
            raise ValueError(f"verify must be one of {VERIFY_CHECKPOINT_MODES}, got {verify!r}")
        path = self._path(tag)
        man = ckpt_manifest.verify_checkpoint_dir(path) if verify != "off" else None
        restored = {}
        try:
            for group in sorted({_group(k) for k in state}):
                restored.update(torch.load(os.path.join(path, STATE_DIR, f"{group}.pt"),
                                           map_location="cpu", weights_only=True))
            meta = {}
            meta_path = os.path.join(path, METADATA_NAME)
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
        except (OSError, EOFError, RuntimeError, ValueError, pickle.UnpicklingError) as e:
            # a verified-or-manifestless file that does not deserialize is
            # still corruption to the caller, whose fallback scan acts on it
            raise CheckpointCorruptError(
                f"checkpoint {path} failed to deserialize: {type(e).__name__}: {e}") from e
        missing, extra = sorted(set(state) - set(restored)), sorted(set(restored) - set(state))
        if missing or extra:
            raise ValueError(f"checkpoint {path} holds another state: missing {missing[:8]}, "
                             f"extra {extra[:8]}")
        bad = [f"{k}: {tuple(restored[k].shape)} {restored[k].dtype} vs {tuple(t.shape)} {t.dtype}"
               for k, t in state.items()
               if restored[k].shape != t.shape or restored[k].dtype != t.dtype]
        if bad:
            raise ValueError(f"checkpoint {path} holds another state: " + "; ".join(bad[:8]))
        if verify == "full":
            ckpt_manifest.verify_state_leaves(restored, man or {}, ckpt_dir=path)
        if load_module_only:
            groups = {MODULE_GROUP}
        else:
            groups = {_group(k) for k in state}
            if not load_optimizer_states:
                groups.discard(OPTIMIZER_GROUP)
        with torch.no_grad():
            for k, t in state.items():
                if _group(k) in groups:
                    t.copy_(restored[k])
        logger.info(f"loaded checkpoint {tag} from {path} (verify: {verify})")
        return meta


__all__ = ["CheckpointCorruptError", "TorchCheckpointEngine"]
