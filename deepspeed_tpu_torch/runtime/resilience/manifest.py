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
manifest keeps JAX's fields (``version``, ``files``, ``leaves``). Leaves and
files are hashed on a few threads (``hashlib`` releases the GIL on large
buffers): a 4 GB tag's digests take seconds on one core.
"""

import hashlib
import json
import logging
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional

import torch

logger = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
_STAGING_PREFIX = ".tmp."
# a tag displaced by an overwrite: `.tmp.<tag>.old.<pid>`
_DISPLACED_RE = re.compile(re.escape(_STAGING_PREFIX) + r"(.+)\.old\.\d+$")


#: threads that hash leaves and files
HASH_THREADS = min(8, os.cpu_count() or 1)


def _map(fn: Callable, items: Iterable) -> List:
    """``[fn(x) for x in items]``, on ``HASH_THREADS`` threads."""
    items = list(items)
    if len(items) < 2 or HASH_THREADS < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(min(HASH_THREADS, len(items))) as pool:
        return list(pool.map(fn, items))


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
    return dict(zip(state, _map(leaf_entry, state.values())))


def _file_entry(path: str) -> dict:
    return {"bytes": os.path.getsize(path), "sha256": _sha256_file(path)}


def file_inventory(root: str) -> dict:
    """``{relpath: {bytes, sha256}}`` for every file under ``root`` (the
    manifest itself excluded: it cannot contain its own hash)."""
    rels = [os.path.relpath(os.path.join(dirpath, name), root)
            for dirpath, _, filenames in os.walk(root) for name in filenames]
    rels = [rel for rel in rels if rel != MANIFEST_NAME]
    return dict(zip(rels, _map(_file_entry, [os.path.join(root, rel) for rel in rels])))


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

    def check(item) -> Optional[str]:
        rel, want = item
        full = os.path.join(ckpt_dir, rel)
        try:
            if not os.path.exists(full):
                return f"missing file {rel}"
            size = os.path.getsize(full)
            if size != want["bytes"]:
                return f"{rel}: size {size} != manifest {want['bytes']} (truncated?)"
            if _sha256_file(full) != want["sha256"]:
                return f"{rel}: sha256 mismatch (bit corruption)"
        except OSError as e:
            return f"{rel}: unreadable ({e})"
        return None

    problems = [p for p in _map(check, (manifest.get("files") or {}).items()) if p]
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


def list_checkpoint_tags(base_dir: str, with_meta: bool = False) -> list:
    """Published tags under ``base_dir``, newest first: by the
    ``global_steps`` in each tag's ``metadata.json``, then by the dir's
    mtime. Staging dirs and dirs holding neither ``state/`` nor a manifest
    are not tags.

    ``with_meta=True`` returns one dict per tag, ``{"tag", "global_steps",
    "world_size", "mesh_axes"}``, from the stamp each save records in
    ``metadata.json``, so that a supervisor decides how a restart resumes
    without opening any state. The port's tags stamp ``world_size`` 1 and
    no ``mesh_axes`` (None); a field the metadata lacks or garbles is None."""
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
        except (OSError, ValueError):
            meta = {}
        if not isinstance(meta, dict):
            meta = {}
        try:
            steps = int(meta.get("global_steps", -1))
        except (ValueError, TypeError):
            steps = -1  # a tag with unreadable steps sorts behind every readable one
        entry = {"tag": name, "global_steps": steps if steps >= 0 else None,
                 "world_size": None, "mesh_axes": None}
        try:
            if meta.get("world_size") is not None:
                entry["world_size"] = int(meta["world_size"])
            if isinstance(meta.get("mesh_axes"), dict):
                entry["mesh_axes"] = {str(a): int(s) for a, s in meta["mesh_axes"].items()}
        except (ValueError, TypeError):
            entry["world_size"] = entry["mesh_axes"] = None
        tags.append((steps, os.path.getmtime(full), name, entry))
    tags.sort(reverse=True, key=lambda t: t[:3])
    if with_meta:
        return [entry for _, _, _, entry in tags]
    return [name for _, _, name, _ in tags]
