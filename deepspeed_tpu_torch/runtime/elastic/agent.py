"""How a restart comes back up, read off checkpoint stamps (the port's copy
of ``deepspeed_tpu/runtime/elastic/agent.py``).

``DSElasticAgent`` must stay alive when the device is what hangs, so it
never touches the card; these helpers read the ``world_size`` and
``mesh_axes`` stamp that every tag's ``metadata.json`` carries
(``DeepSpeedEngine.save_checkpoint``: world size 1, no mesh axes), a few
hundred bytes of JSON, and never open the state.
"""

import os
from typing import Dict, Optional

from deepspeed_tpu_torch.runtime.resilience.manifest import list_checkpoint_tags


def normalized_axes(mesh_axes: Optional[Dict[str, int]]) -> Dict[str, int]:
    """Axis sizes without the size-1 axes: what actually shards data."""
    return {str(a): int(s) for a, s in (mesh_axes or {}).items() if int(s) > 1}


def checkpoint_topology(base_dir: str, tag: Optional[str] = None) -> Optional[Dict]:
    """The stamp of ``tag`` (default: the one ``latest`` names, else the
    newest tag) under ``base_dir``, in ``list_checkpoint_tags``'s
    ``with_meta`` shape ``{"tag", "global_steps", "world_size",
    "mesh_axes"}``, or None when no tag is published."""
    entries = {e["tag"]: e for e in list_checkpoint_tags(base_dir, with_meta=True)}
    if not entries:
        return None
    if tag is None:
        newest = next(iter(entries))
        try:
            with open(os.path.join(base_dir, "latest")) as f:
                marker = f.read().strip()
            tag = marker if marker in entries else newest
        except OSError:
            tag = newest
    return entries.get(tag)


def decide_resume(base_dir: Optional[str], target_world: int,
                  target_axes: Optional[Dict[str, int]] = None) -> Dict:
    """How the next attempt at ``target_world`` comes back up: ``fresh`` (no
    checkpoint), ``plain`` (the same topology: the bit-exact resume),
    ``reshard`` (another world size or axis split; the port's engine
    refuses that until ``resume_elastic`` is ported) or ``unknown`` (a tag
    without a stamp). At one card, an existing tag reads ``plain``."""
    decision = {"resume": "fresh", "tag": None, "ckpt_world": None,
                "ckpt_axes": None, "world_size": int(target_world)}
    info = checkpoint_topology(base_dir) if base_dir else None
    if info is None:
        return decision
    decision.update(tag=info["tag"], ckpt_world=info["world_size"],
                    ckpt_axes=info["mesh_axes"])
    if info["world_size"] is None:
        decision["resume"] = "unknown"
    elif info["world_size"] != int(target_world):
        decision["resume"] = "reshard"
    elif (target_axes is not None and info["mesh_axes"] is not None
          and normalized_axes(target_axes) != normalized_axes(info["mesh_axes"])):
        decision["resume"] = "reshard"  # the same world size, another axis split
    else:
        decision["resume"] = "plain"
    return decision
