"""Offline consolidation of an engine checkpoint into plain fp32 (or bf16)
weights (counterpart of ``deepspeed_tpu/checkpoint/zero_to_fp32.py``,
reference ``deepspeed/utils/zero_to_fp32.py``).

A port tag holds the fp32 parameters in ``<tag>/state/module.pt`` under
``module/<name>`` (``runtime/checkpoint_engine/torch_engine.py``);
consolidation reads that file alone, after the tag's integrity gate
(``runtime/resilience/manifest.py``: that file's size and sha256 before it
is deserialized, each parameter's digest after), and never reads or
hashes the optimizer's.
The deployment format is the JAX package's ``.npz``: JAX paths
(``h_0/attn/c_attn/kernel``), bf16 stored as its ``uint16`` bits with a
``__dtypes__`` map, so either package reads what the other wrote. Neither
package reads the other's checkpoint tags.

Run as ``python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32
<checkpoint_dir> <output_dir> [-t TAG] [-d bfloat16]``.
"""

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.from_jax import jax_paths, params_to_jax
from deepspeed_tpu_torch.models.common import nest_tree
from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_engine import (METADATA_NAME, MODULE_GROUP,
                                                                        STATE_DIR)
from deepspeed_tpu_torch.runtime.resilience import manifest as ckpt_manifest

WEIGHTS_NAME = "model_weights.npz"          # reference writes pytorch_model.bin

_SAVE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                "float16": torch.float16}


def _latest_tag(checkpoint_dir: str) -> str:
    latest = os.path.join(checkpoint_dir, "latest")
    if not os.path.exists(latest):
        raise FileNotFoundError(f"no 'latest' file in {checkpoint_dir}; pass tag= explicitly")
    with open(latest) as f:
        return f.read().strip()


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The port's state dict (``{name: fp32 CPU tensor}``) of the
    parameters in ``checkpoint_dir/<tag>`` (default: the tag ``latest``
    names). Raises ``FileNotFoundError`` without the tag and
    ``CheckpointCorruptError`` when it fails its manifest."""
    tag = str(tag or _latest_tag(checkpoint_dir))
    path = os.path.join(os.path.abspath(checkpoint_dir), tag)
    module_file = os.path.join(path, STATE_DIR, f"{MODULE_GROUP}.pt")
    if not os.path.exists(module_file):
        raise FileNotFoundError(f"checkpoint state not found at {module_file}")
    man = ckpt_manifest.read_manifest(path) or {}
    prefix = f"{MODULE_GROUP}/"
    # the gate over the files read here: the module's and the metadata
    # (the optimizer's moments, twice the bytes, are neither read nor hashed)
    rel = os.path.join(STATE_DIR, f"{MODULE_GROUP}.pt")
    files = {k: v for k, v in (man.get("files") or {}).items() if k in (rel, METADATA_NAME)}
    if man:
        ckpt_manifest.verify_checkpoint_dir(path, {"files": files})
    else:
        ckpt_manifest.verify_checkpoint_dir(path)  # warns: nothing to verify against
    state = torch.load(module_file, map_location="cpu", weights_only=True)
    want = {k: v for k, v in (man.get("leaves") or {}).items() if k.startswith(prefix)}
    ckpt_manifest.verify_state_leaves(state, {"leaves": want}, ckpt_dir=path)
    return {k[len(prefix):]: (v.float() if v.is_floating_point() else v)
            for k, v in state.items() if k.startswith(prefix)}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_dir: str,
                                               tag: Optional[str] = None,
                                               save_dtype: str = "float32") -> str:
    """Write the consolidated weights npz (JAX paths) and its
    ``manifest.json`` into ``output_dir``; returns the npz's path. Pass
    ``save_dtype="bfloat16"`` for the ``save_16bit_model`` deployment
    format."""
    if save_dtype not in _SAVE_DTYPES:
        raise ValueError(f"save_dtype must be one of {sorted(_SAVE_DTYPES)}, got {save_dtype!r}")
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    dt = _SAVE_DTYPES[save_dtype]
    cast = {k: (v.to(dt) if v.is_floating_point() else v) for k, v in sd.items()}
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, WEIGHTS_NAME)
    save_npz(out_path, cast)
    with open(os.path.join(output_dir, "manifest.json"), "w") as f:
        json.dump({"dtype": str(save_dtype),
                   "num_params": int(sum(v.numel() for v in cast.values())),
                   "keys": sorted(jax_paths(cast).values())}, f, indent=2)
    return out_path


def save_npz(out_path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write a port state dict as the JAX package's npz: JAX paths, bf16
    leaves as their ``uint16`` bits under a ``__dtypes__`` map that
    :func:`load_state_dict_from_npz` (and JAX's) reverse."""
    flat = params_to_jax(state_dict)
    dtypes = {path: ("bfloat16" if t.dtype == torch.bfloat16 else str(a.dtype))
              for (path, a), t in zip(flat.items(), state_dict.values())}
    with open(out_path, "wb") as f:  # a file object: np.savez appends no ".npz"
        np.savez(f, __dtypes__=np.frombuffer(json.dumps(dtypes).encode(), np.uint8), **flat)


def load_state_dict_from_npz(path: str) -> dict:
    """Deployment-side loader: an npz (or a directory holding
    :data:`WEIGHTS_NAME`) -> the nested param tree under its JAX paths, as
    CPU tensors (bf16 read back from its bits with ``Tensor.view``).
    ``checkpoint.from_jax.params_from_jax`` turns it into a state dict."""
    if os.path.isdir(path):
        path = os.path.join(path, WEIGHTS_NAME)
    with np.load(path) as z:
        dtypes = {}
        if "__dtypes__" in z.files:
            dtypes = json.loads(bytes(z["__dtypes__"]).decode())
        flat = {}
        for k in z.files:
            if k == "__dtypes__":
                continue
            v = torch.from_numpy(np.array(z[k], copy=True))
            if dtypes.get(k) == "bfloat16":
                v = v.view(torch.bfloat16)
            flat[k] = v
    return nest_tree(flat, "/")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Consolidate a deepspeed_tpu_torch engine checkpoint into a plain fp32 "
                    "(or bf16) weights npz (reference utils/zero_to_fp32.py)")
    p.add_argument("checkpoint_dir", help="dir passed to engine.save_checkpoint")
    p.add_argument("output_dir", help=f"where to write {WEIGHTS_NAME}")
    p.add_argument("-t", "--tag", default=None, help="checkpoint tag (default: latest)")
    p.add_argument("-d", "--dtype", default="float32", choices=["float32", "bfloat16", "float16"])
    args = p.parse_args(argv)
    print(convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_dir,
                                                     tag=args.tag, save_dtype=args.dtype))


if __name__ == "__main__":
    main()


__all__ = ["WEIGHTS_NAME", "convert_zero_checkpoint_to_fp32_state_dict",
           "get_fp32_state_dict_from_zero_checkpoint", "load_state_dict_from_npz", "main",
           "save_npz"]
