"""The port's checkpoint backend (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/orbax_engine.py``, after upstream
``TorchCheckpointEngine``).

A state is a flat ``{"<group>/<name>": tensor}`` dict of the live tensors
(``DeepSpeedEngine.checkpoint_state``): group ``module`` the parameters,
``optimizer`` the optimizer state, any other group (the engine's ``rng``)
state that travels with the counters (``host_optimizer`` the host
optimizer's step and moments under ``offload_optimizer``, an optimizer group
as well). A tag is a directory::

    <tag>/state/<group>.pt   one torch.save'd {name: tensor} per group
    <tag>/metadata.json      the engine's counters and client_state (JSON)
    <tag>/manifest.json      file inventory and per-leaf digests

``save`` copies each tensor to the host once, hashes that copy and writes
it into the staging dir ``.tmp.<tag>``, then writes the manifest, fsyncs
and renames the dir into place (``runtime/resilience/manifest.py``); until
the rename the tag is invisible. ``save(..., use_async=True)`` takes a
consistent snapshot at the call instead (device-to-host copies into a
:class:`HostSnapshotPool`'s reused buffers, on a side stream, behind an
event the caller's next in-place update must wait on) and leaves the
digests, ``torch.save``, the file digests and the fsync to a background
writer; ``commit(tag)`` joins it, re-raises any error it hit, writes the
manifest and publishes. The ``ckpt_pre_rename`` fault point
(``runtime/resilience/faults.py``) sits right before every publish.
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
import threading
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import CheckpointEngine
from deepspeed_tpu_torch.runtime.config import VERIFY_CHECKPOINT_MODES
from deepspeed_tpu_torch.runtime.resilience import manifest as ckpt_manifest
from deepspeed_tpu_torch.runtime.resilience.faults import fault_point
from deepspeed_tpu_torch.runtime.resilience.manifest import CheckpointCorruptError

logger = logging.getLogger(__name__)

STATE_DIR = "state"
METADATA_NAME = "metadata.json"
MODULE_GROUP = "module"
OPTIMIZER_GROUP = "optimizer"
#: the host optimizer's state under ``offload_optimizer``
HOST_OPTIMIZER_GROUP = "host_optimizer"


def _group(name: str) -> str:
    return name.split("/", 1)[0]


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host in a storage of its own (``torch.save`` writes a
    view's whole storage)."""
    host = t.detach().cpu()
    if not host.is_contiguous() or host.untyped_storage().nbytes() != host.nbytes:
        host = host.contiguous().clone()
    return host


class HostSnapshotPool:
    """Host buffers for async snapshots, kept across saves: one flat buffer
    per (group, dtype), pinned when the state lives on a GPU (a 4 GB
    ``cudaHostAlloc`` a save would cost seconds), each state tensor a view
    at a 64-byte-aligned offset. ``torch.save`` of a group's views writes
    each buffer once. A pool serves one pending save at a time."""

    ALIGN = 64

    def __init__(self):
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def _views(self, state: Dict[str, torch.Tensor], pin: bool) -> Dict[str, torch.Tensor]:
        offsets, sizes = {}, {}
        for name, t in state.items():
            key = (_group(name), t.dtype)
            offsets[name] = sizes.get(key, 0)
            sizes[key] = offsets[name] + -(-t.numel() * t.element_size() // self.ALIGN) * self.ALIGN
        for key, size in sizes.items():
            buf = self._buffers.get(key)
            if buf is None or buf.numel() != size or buf.is_pinned() != pin:
                self._buffers[key] = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
        views = {}
        for name, t in state.items():
            buf = self._buffers[(_group(name), t.dtype)]
            nbytes = t.numel() * t.element_size()
            views[name] = buf[offsets[name]:offsets[name] + nbytes].view(t.dtype).view(t.shape)
        return views

    def snapshot(self, state: Dict[str, torch.Tensor]):
        """Copies of ``state``'s values at this call, in the pool's buffers,
        and the CUDA event after which they are complete (None when every
        copy was synchronous). The copies run on a side stream that first
        waits for the current one; a writer of any ``state`` tensor must
        wait on the event first."""
        cuda = [t.device for t in state.values() if t.is_cuda]
        views = self._views(state, pin=bool(cuda))
        if not cuda:
            with torch.no_grad():
                for name, t in state.items():
                    views[name].copy_(t)
            return views, None
        device = cuda[0]
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad(), torch.cuda.stream(stream):
            for name, t in state.items():
                views[name].copy_(t.detach(), non_blocking=t.is_cuda)
        ready = torch.cuda.Event(blocking=True)  # the writer sleeps on it, not spins
        ready.record(stream)
        return views, ready


class _PendingSave:
    """An async save's background writer and what it left: the manifest,
    or the error to re-raise at commit."""

    def __init__(self, staging: str, host: dict, meta_text: Optional[str], ready):
        self.staging = staging
        self.manifest: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, args=(host, meta_text, ready),
                                       name=f"checkpoint-writer {os.path.basename(staging)}")
        self.thread.start()

    def _run(self, host, meta_text, ready):
        try:
            if ready is not None:
                ready.synchronize()
            self.manifest = _write_staging(self.staging, host, meta_text)
            ckpt_manifest.fsync_tree(self.staging)
        except BaseException as e:  # noqa: BLE001 (re-raised by commit)
            self.error = e


def _write_staging(staging: str, host: Dict[str, torch.Tensor], meta_text: Optional[str]) -> dict:
    """Hash the host state's leaves, ``torch.save`` one file per group and
    the metadata into ``staging``; returns the manifest to publish."""
    leaves = ckpt_manifest.state_leaf_entries(host)
    for group in sorted({_group(k) for k in host}):
        torch.save({k: v for k, v in host.items() if _group(k) == group},
                   os.path.join(staging, STATE_DIR, f"{group}.pt"))
    if meta_text is not None:
        with open(os.path.join(staging, METADATA_NAME), "w") as f:
            f.write(meta_text)
    return ckpt_manifest.build_manifest(staging, leaf_entries=leaves)


class TorchCheckpointEngine(CheckpointEngine):

    def __init__(self, base_dir: str):
        self.base_dir = os.path.abspath(base_dir)
        self._pending: Dict[str, _PendingSave] = {}

    def _path(self, tag) -> str:
        return os.path.join(self.base_dir, str(tag))

    def save(self, state: Dict[str, torch.Tensor], tag, metadata: Optional[dict] = None,
             use_async: bool = False, pool: Optional[HostSnapshotPool] = None):
        """Write ``tag`` and publish it atomically; when this returns the
        tag is complete and verifiable. ``metadata`` must be JSON.

        ``use_async``: snapshot ``state`` into ``pool`` (a fresh one by
        default) and return at once; a background writer stages the tag and
        :meth:`commit` publishes it. Returns the snapshot's CUDA event
        (None when the copies were synchronous): no tensor of ``state`` may
        be written before the event completes."""
        tag = str(tag)
        meta_text = json.dumps(metadata) if metadata is not None else None
        staging = ckpt_manifest.staging_path(self.base_dir, tag)
        os.makedirs(self.base_dir, exist_ok=True)
        ckpt_manifest.sweep_stale_staging(self.base_dir,
                                          exclude=[p.staging for p in self._pending.values()])
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(os.path.join(staging, STATE_DIR))
        if use_async:
            if tag in self._pending:
                raise RuntimeError(f"checkpoint {tag} already has a pending save; commit it first")
            host, ready = (pool or HostSnapshotPool()).snapshot(state)
            self._pending[tag] = _PendingSave(staging, host, meta_text, ready)
            return ready
        host = {name: _host_copy(t) for name, t in state.items()}
        self._publish(staging, tag, _write_staging(staging, host, meta_text))
        return None

    def commit(self, tag) -> None:
        """Finish an async save of ``tag``: wait for its writer, re-raise any
        error it hit (the tag then stays unpublished), write the manifest
        and publish atomically."""
        pending = self._pending.pop(str(tag))
        pending.thread.join()
        if pending.error is not None:
            raise pending.error
        self._publish(pending.staging, str(tag), pending.manifest)

    def _publish(self, staging: str, tag: str, manifest: dict) -> None:
        ckpt_manifest.write_manifest(staging, manifest)
        fault_point("ckpt_pre_rename")  # the torn-save injection: die between staging and publish
        ckpt_manifest.atomic_publish(staging, self._path(tag))
        logger.info(f"published checkpoint {tag} -> {self._path(tag)}")

    def load(self, state: Dict[str, torch.Tensor], tag, load_optimizer_states: bool = True,
             load_module_only: bool = False, verify: str = "full") -> dict:
        """Restore ``tag`` into ``state``'s tensors in place and return the
        tag's metadata. ``verify``: "off", "files" (the inventory before
        deserializing) or "full" (and every leaf's digest after).
        ``load_module_only`` copies the module group alone,
        ``load_optimizer_states=False`` every group but the optimizer's
        (``optimizer`` and ``host_optimizer``).
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
            # the leaves of the groups read (a tag may hold a group this
            # state has none of: an optimizer saved without offload, read
            # by an engine that offloads it)
            read = {_group(k) for k in state}
            man = dict(man or {})
            if man.get("leaves"):
                man["leaves"] = {k: v for k, v in man["leaves"].items() if _group(k) in read}
            ckpt_manifest.verify_state_leaves(restored, man, ckpt_dir=path)
        if load_module_only:
            groups = {MODULE_GROUP}
        else:
            groups = {_group(k) for k in state}
            if not load_optimizer_states:
                groups -= {OPTIMIZER_GROUP, HOST_OPTIMIZER_GROUP}
        with torch.no_grad():
            for k, t in state.items():
                if _group(k) in groups:
                    t.copy_(restored[k])
        logger.info(f"loaded checkpoint {tag} from {path} (verify: {verify})")
        return meta


__all__ = ["CheckpointCorruptError", "HostSnapshotPool", "TorchCheckpointEngine"]
