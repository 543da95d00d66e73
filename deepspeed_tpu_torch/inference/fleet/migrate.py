"""Live KV migration: scheduler payloads to and from a digest-verified
bundle directory (counterpart of ``deepspeed_tpu/inference/fleet/migrate.py``).

A replica that gets SIGTERM exports every in-flight request
(``scheduler.export_inflight``: host bookkeeping and the slot's committed
KV rows; int8 KV travels as its codes and scales) and lands them as one
bundle directory through the checkpoint manifest machinery
(``runtime/resilience/manifest.py``):

* each request's arrays in ``req_<origin_id>.npz`` (the prompt, and every
  KV leaf under ``<role>::<leaf key>``);
* the scalar bookkeeping in ``bundle.json``;
* ``manifest.json`` with the file inventory and each KV leaf's shape,
  dtype and sha256;
* published crash-atomically (staging, fsync, rename), so a receiver
  never sees a partial bundle.

The receiver verifies twice: the file inventory before anything is
deserialized, then each leaf's digest over the deserialized tensors.
Either failing raises :class:`MigrationError`; a capacity shortfall on the
receiver is not an error: :func:`restore_into` returns the refused
payloads for the router to place elsewhere.

The files, manifest fields and leaf keys are the JAX package's, so a
bundle written by either package is read by the other. The port names a
cache leaf by its flat path (``h_0/attn/cached_key``); a bundle names it
by the JAX cache's ``keystr`` (``['h_0']['attn']['cached_key']``), and
the mapping happens here only. A bf16 leaf is stored as numpy stores the
JAX package's bf16 arrays: two raw bytes an element (``|V2``), its dtype
``bfloat16`` in the manifest.
"""

import json
import logging
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.inference.serving.scheduler import MigrationError
from deepspeed_tpu_torch.runtime.resilience.manifest import (CheckpointCorruptError,
                                                             atomic_publish, build_manifest,
                                                             staging_path, state_leaf_entries,
                                                             verify_checkpoint_dir,
                                                             verify_state_leaves, write_manifest)

logger = logging.getLogger(__name__)

BUNDLE_META = "bundle.json"
BUNDLE_VERSION = 1

#: payload fields that are plain JSON scalars or lists (the prompt and the
#: KV rows travel in the npz). The rows are the slot's own (shared prefix
#: blocks travel as bytes), so the prefix cache needs only its accounting
#: scalar and the ``prefix_cache`` compat knob here.
_SCALAR_FIELDS = ("request_id", "state", "max_new_tokens", "eos_token_id",
                  "arrival_time", "output", "prefill_pos", "first_token_time",
                  "token_times", "drafted_tokens", "accepted_tokens", "meta",
                  "length", "next_token", "kv_quant", "weight_dtype",
                  "capacity", "spec_k", "cached_prefix_tokens", "prefix_cache")

_KEY_PART = re.compile(r"\['([^'\\]*)'\]")


def leaf_key(name: str) -> str:
    """A port cache leaf name as the JAX cache's ``keystr``:
    ``h_0/attn/cached_key`` -> ``['h_0']['attn']['cached_key']``."""
    return "".join(f"[{part!r}]" for part in name.split("/"))


def leaf_name(key: str) -> str:
    """The inverse of :func:`leaf_key`; raises :class:`MigrationError` on a
    key that is not a path of string dict keys."""
    parts = _KEY_PART.findall(key)
    if not parts or "".join(f"['{p}']" for p in parts) != key:
        raise MigrationError(f"migration bundle leaf key {key!r} is not a cache path")
    return "/".join(parts)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _npz_name(origin_id: int) -> str:
    return f"req_{int(origin_id)}.npz"


def _kv_state(payloads: List[dict]) -> Dict[str, torch.Tensor]:
    """The bundle's KV rows as the flat state the manifest digests, keyed as
    the JAX package keys its nested ``{origin id: {role: {leaf key: rows}}}``
    tree (``keystr`` of the path), so either package verifies the other's."""
    return {f"[{str(p['request_id'])!r}][{role!r}][{leaf_key(name)!r}]": torch.as_tensor(rows)
            for p in payloads for role, leaves in p["kv"].items() for name, rows in leaves.items()}


def save_bundle(payloads: List[dict], bundle_dir: str) -> str:
    """Land ``payloads`` (from ``scheduler.export_inflight``) as a published
    bundle directory; returns ``bundle_dir``. Crash-atomic: a kill during
    the save leaves only an inert staging dir, never a torn bundle."""
    if not payloads:
        raise MigrationError("empty migration payload list: nothing to bundle")
    base = os.path.dirname(os.path.abspath(bundle_dir)) or "."
    os.makedirs(base, exist_ok=True)
    staging = staging_path(base, os.path.basename(bundle_dir))
    os.makedirs(staging, exist_ok=True)
    meta = {"version": BUNDLE_VERSION, "requests": []}
    for p in payloads:
        rec = {k: p[k] for k in _SCALAR_FIELDS}
        rec["npz"] = _npz_name(p["request_id"])
        arrays = {"prompt": np.asarray(p["prompt"], np.int32)}
        for role, leaves in p["kv"].items():
            for name, rows in leaves.items():
                arrays[f"{role}::{leaf_key(name)}"] = _to_numpy(torch.as_tensor(rows))
        np.savez(os.path.join(staging, rec["npz"]), **arrays)
        meta["requests"].append(rec)
    with open(os.path.join(staging, BUNDLE_META), "w") as fh:
        json.dump(meta, fh, indent=1)
    manifest = build_manifest(staging, leaf_entries=state_leaf_entries(_kv_state(payloads)),
                              extra={"kind": "kv_migration_bundle"})
    write_manifest(staging, manifest)
    atomic_publish(staging, bundle_dir)
    logger.info(f"fleet: migration bundle published at {bundle_dir} ({len(payloads)} requests)")
    return bundle_dir


def load_bundle(bundle_dir: str) -> List[dict]:
    """Read and verify a bundle back into scheduler payloads (KV rows as CPU
    tensors under the port's leaf names). The file inventory is checked
    before anything is deserialized, each KV leaf's digest after; either
    failing raises :class:`MigrationError`: corrupt KV never reaches a slot."""
    try:
        manifest = verify_checkpoint_dir(bundle_dir)
    except CheckpointCorruptError as e:
        raise MigrationError(f"migration bundle failed integrity verification: {e}") from e
    meta_path = os.path.join(bundle_dir, BUNDLE_META)
    try:
        with open(meta_path) as fh:
            meta = json.load(fh)
    except (OSError, ValueError) as e:
        raise MigrationError(f"unreadable bundle meta {meta_path}: {e}") from e
    payloads: List[dict] = []
    for rec in meta.get("requests", []):
        kv: Dict[str, Dict[str, torch.Tensor]] = {}
        prompt = None
        with np.load(os.path.join(bundle_dir, rec["npz"])) as npz:
            for key in npz.files:
                if key == "prompt":
                    prompt = np.asarray(npz[key], np.int32)
                    continue
                role, _, key_path = key.partition("::")
                kv.setdefault(role, {})[leaf_name(key_path)] = _to_tensor(npz[key])
        p = {k: rec[k] for k in _SCALAR_FIELDS}
        p["prompt"] = prompt
        p["kv"] = kv
        payloads.append(p)
    try:
        verify_state_leaves(_kv_state(payloads), manifest, bundle_dir)
    except CheckpointCorruptError as e:
        raise MigrationError(f"migrated KV failed digest verification: {e}") from e
    return payloads


def restore_into(scheduler, payloads: List[dict], bundle_dir: str = "") -> Tuple[List, List[dict]]:
    """Admit verified payloads into ``scheduler``; returns ``(admitted
    requests, refused payloads)``. A capacity refusal (no free slot or
    blocks) comes back as a payload for the router to place elsewhere; a
    compat mismatch raises (``admit_migrated``)."""
    admitted, refused = [], []
    for p in payloads:
        req = scheduler.admit_migrated(p)
        if req is None:
            refused.append(p)
        else:
            admitted.append(req)
    if scheduler.telemetry is not None:
        scheduler.telemetry.emit("serve_migrate_in", migrated=len(admitted),
                                 refused=len(refused), bundle=str(bundle_dir))
    return admitted, refused


def receive_bundle(scheduler, bundle_dir: str) -> Tuple[List, List[dict]]:
    """The receiver's whole path: verify, deserialize, verify again, admit."""
    return restore_into(scheduler, load_bundle(bundle_dir), bundle_dir)


def make_bundle_migrate(bundle_dir: str) -> Callable:
    """A ``scheduler.serve(migrate=...)`` hook that lands the in-flight work
    at ``bundle_dir``. The export keeps the slots; only a published bundle
    releases them, so a failed save leaves the scheduler to drain."""
    def _migrate(scheduler, signal: str) -> dict:
        payloads = scheduler.export_inflight(release=False)
        if not payloads:
            return {"migrated": 0, "bundle": bundle_dir}
        try:
            save_bundle(payloads, bundle_dir)
        except MigrationError:
            raise
        except Exception as e:  # noqa: BLE001 - any save failure means drain
            raise MigrationError(f"bundle save failed: {type(e).__name__}: {e}") from e
        scheduler.release_inflight()
        return {"migrated": len(payloads), "bundle": bundle_dir}
    return _migrate


def bundle_rids(payloads: List[dict]) -> List[Optional[str]]:
    """The fleet-wide ids in each payload's ``meta`` (None for requests
    submitted outside a router)."""
    return [p.get("meta", {}).get("fleet_rid") for p in payloads]
