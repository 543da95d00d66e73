"""Checkpoint integrity manifests and crash-atomic publish (the port's copy
of ``deepspeed_tpu/runtime/resilience/manifest.py``).

* **Atomicity**: a save lands in a ``.tmp.<tag>`` staging dir and is
  published by fsync + rename (:func:`atomic_publish`). A tag directory
  exists complete or not at all; a killed writer leaves an inert staging
  dir that the next save or ``resume`` sweeps.
* **Verification**: ``manifest.json`` inside the tag records (a) a file
  inventory (relpath -> size + sha256), checked *before* anything is
  deserialized, so a truncated or bit-flipped file is caught unread, and
  (b) each state leaf's shape, dtype and sha256, checked against the
  deserialized tensors *after* the load, so the whole storage round trip
  is proven.

The JAX version hashes the leaves of a pytree; here a state is a flat
``{name: tensor}`` dict, each leaf hashed as contiguous CPU bytes. The
manifest keeps JAX's fields (``version``, ``files``, ``leaves``).
"""

import hashlib
import json
import logging
import os
import re
import shutil
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
_STAGING_PREFIX = ".tmp."
# a tag displaced by an overwrite: `.tmp.<tag>.old.<pid>`
_DISPLACED_RE = re.compile(re.escape(_STAGING_PREFIX) + r"(.+)\.old\.\d+$")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (torn, truncated or
    bit-flipped). ``DeepSpeedEngine.load_checkpoint`` falls back to the
    newest older intact tag or raises it; garbage is never loaded."""


def _sha256_file(path: str, chunk: int = 1 << 22) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (numpy's names, as in JAX's
    manifests)."""
    return str(dtype).removeprefix("torch.")


def leaf_entry(t: torch.Tensor) -> dict:
    """``{shape, dtype, sha256}`` of one tensor; a CUDA tensor is copied to
    the host first. The bytes are hashed C-contiguous, so the digest does
    not depend on strides."""
    t = t.detach().cpu().contiguous()
    return {"shape": list(t.shape), "dtype": dtype_name(t.dtype),
            "sha256": hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy()).hexdigest()}


def state_leaf_entries(state: Dict[str, torch.Tensor]) -> dict:
    """``{name: {shape, dtype, sha256}}`` over a flat ``{name: tensor}``
    state."""
    return {name: leaf_entry(t) for name, t in state.items()}


def file_inventory(root: str) -> dict:
    """``{relpath: {bytes, sha256}}`` for every file under ``root`` (the
    manifest itself excluded: it cannot contain its own hash)."""
    inv = {}
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            if rel == MANIFEST_NAME:
                continue
            inv[rel] = {"bytes": os.path.getsize(full), "sha256": _sha256_file(full)}
    return inv


def build_manifest(ckpt_dir: str, leaf_entries: Optional[dict] = None) -> dict:
    return {"version": MANIFEST_VERSION, "files": file_inventory(ckpt_dir),
            "leaves": leaf_entries}


def write_manifest(ckpt_dir: str, manifest: dict) -> str:
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    return path


def read_manifest(ckpt_dir: str) -> Optional[dict]:
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"unreadable manifest at {path}: {e}") from e


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_tree(root: str) -> None:
    """fsync every file and directory under ``root``, ``root`` included:
    the durability barrier before the rename, which could otherwise reach
    the disk before the data it publishes."""
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            _fsync_path(os.path.join(dirpath, name))
        _fsync_path(dirpath)


def _fsync_dir(path: str) -> None:
    try:
        _fsync_path(path)
    except OSError:
        pass  # a directory that cannot be opened cannot be synced either


def staging_path(base_dir: str, tag: str) -> str:
    return os.path.join(base_dir, f"{_STAGING_PREFIX}{tag}")


def sweep_stale_staging(base_dir: str, exclude=None) -> None:
    """Clean up after crashed saves. A ``.tmp.<tag>`` staging dir is an
    inert partial write and is removed. A ``.tmp.<tag>.old.<pid>`` dir holds
    the intact previous copy of a tag displaced mid-overwrite: it is
    restored to ``<tag>`` when the tag is missing, and removed only when the
    overwrite completed. ``exclude``: the staging dir(s) of saves in flight
    (a path or a collection of paths)."""
    if not os.path.isdir(base_dir):
        return
    if exclude is None:
        keep = set()
    elif isinstance(exclude, str):
        keep = {os.path.basename(exclude)}
    else:
        keep = {os.path.basename(e) for e in exclude}
    for name in sorted(os.listdir(base_dir)):
        if not name.startswith(_STAGING_PREFIX) or name in keep:
            continue
        full = os.path.join(base_dir, name)
        m = _DISPLACED_RE.match(name)
        if m is not None and not os.path.exists(os.path.join(base_dir, m.group(1))):
            logger.error(f"restoring displaced checkpoint {name} -> {m.group(1)}: a tag "
                         f"overwrite crashed between displace and publish")
            os.rename(full, os.path.join(base_dir, m.group(1)))
            continue
        logger.warning(f"sweeping stale checkpoint staging dir {name} (a previous save was "
                       f"interrupted mid-write)")
        shutil.rmtree(full, ignore_errors=True)


def atomic_publish(staging_dir: str, final_dir: str) -> None:
    """fsync the staged tree, then rename it into place. An existing
    ``final_dir`` (a tag overwrite) is first displaced to
    ``.tmp.<tag>.old.<pid>`` and removed once the new tree is visible, so a
    reader never sees a partial tag; a crash between the two renames leaves
    the displaced copy for :func:`sweep_stale_staging` to restore."""
    fsync_tree(staging_dir)
    displaced = None
    if os.path.exists(final_dir):
        displaced = os.path.join(os.path.dirname(final_dir),
                                 f"{_STAGING_PREFIX}{os.path.basename(final_dir)}.old.{os.getpid()}")
        os.rename(final_dir, displaced)
    os.rename(staging_dir, final_dir)
    _fsync_dir(os.path.dirname(final_dir) or ".")
    if displaced is not None:
        shutil.rmtree(displaced, ignore_errors=True)


def write_atomic_text(path: str, text: str) -> None:
    """Durable single-file publish (the ``latest`` marker): write a temp
    file, fsync, rename. A crash leaves the old marker or the new one."""
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def verify_checkpoint_dir(ckpt_dir: str, manifest: Optional[dict] = None) -> dict:
    """The gate before deserializing: every file of the manifest's
    inventory must exist with its size and sha256. Returns the manifest;
    raises :class:`CheckpointCorruptError` naming every discrepancy. A
    checkpoint without a manifest passes with a warning (nothing to verify
    against)."""
    if manifest is None:
        manifest = read_manifest(ckpt_dir)
    if manifest is None:
        logger.warning(f"checkpoint {ckpt_dir} has no integrity manifest; loading unverified")
        return {}
    problems = []
    for rel, want in (manifest.get("files") or {}).items():
        full = os.path.join(ckpt_dir, rel)
        try:
            if not os.path.exists(full):
                problems.append(f"missing file {rel}")
                continue
            size = os.path.getsize(full)
            if size != want["bytes"]:
                problems.append(f"{rel}: size {size} != manifest {want['bytes']} (truncated?)")
                continue
            digest = _sha256_file(full)
        except OSError as e:
            problems.append(f"{rel}: unreadable ({e})")
            continue
        if digest != want["sha256"]:
            problems.append(f"{rel}: sha256 mismatch (bit corruption)")
    if problems:
        raise CheckpointCorruptError(f"checkpoint {ckpt_dir} failed integrity verification: "
                                     + "; ".join(problems))
    return manifest


def verify_state_leaves(state: Dict[str, torch.Tensor], manifest: dict, ckpt_dir: str = "") -> None:
    """The gate after deserializing: each leaf's shape, dtype and sha256
    must match what the save recorded."""
    want = manifest.get("leaves") if manifest else None
    if not want:
        return
    got = state_leaf_entries({k: state[k] for k in want if k in state})
    problems = []
    for key, entry in want.items():
        g = got.get(key)
        if g is None:
            problems.append(f"leaf {key} missing from restored state")
        elif g != entry:
            problems.append(f"leaf {key}: restored {g} != saved {entry}")
    if problems:
        raise CheckpointCorruptError(
            f"restored state from {ckpt_dir or 'checkpoint'} does not match its save-time "
            f"manifest: " + "; ".join(problems[:8])
            + (f" (+{len(problems) - 8} more)" if len(problems) > 8 else ""))


def list_checkpoint_tags(base_dir: str) -> list:
    """Published tags under ``base_dir``, newest first: by the
    ``global_steps`` in each tag's ``metadata.json``, then by the dir's
    mtime. Staging dirs and dirs holding neither ``state/`` nor a manifest
    are not tags."""
    if not os.path.isdir(base_dir):
        return []
    tags = []
    for name in os.listdir(base_dir):
        full = os.path.join(base_dir, name)
        if name.startswith(_STAGING_PREFIX) or not os.path.isdir(full):
            continue
        if not (os.path.exists(os.path.join(full, "state"))
                or os.path.exists(os.path.join(full, MANIFEST_NAME))):
            continue
        try:
            with open(os.path.join(full, "metadata.json")) as f:
                meta = json.load(f)
            steps = int(meta.get("global_steps", -1)) if isinstance(meta, dict) else -1
        except (OSError, ValueError, TypeError):
            steps = -1  # a tag with unreadable metadata sorts behind every readable one
        tags.append((steps, os.path.getmtime(full), name))
    tags.sort(reverse=True)
    return [name for _, _, name in tags]
