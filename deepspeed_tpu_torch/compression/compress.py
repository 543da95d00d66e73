"""Layer reduction (counterpart of ``student_initialization`` and the
``layer_reduction`` parse of ``deepspeed_tpu/compression/``): a shallower
student seeded from chosen teacher layers. The port's trees are state
dicts (``module.state_dict()``), whose block ``i`` sits under the key
prefix ``h_{i}.`` where the JAX tree has a ``h_{i}`` subtree."""

import logging
from typing import Any, Dict

import torch

logger = logging.getLogger(__name__)

COMPRESSION_TRAINING = "compression_training"
LAYER_REDUCTION = "layer_reduction"


def layer_reduction_config(ds_config: Dict[str, Any]) -> Dict[str, Any]:
    """The ``compression_training.layer_reduction`` block as the JAX parse
    returns it: ``enabled`` made a bool, every other key as given."""
    block = (ds_config or {}).get(COMPRESSION_TRAINING, {}) or {}
    lr = block.get(LAYER_REDUCTION, {}) or {}
    return dict(enabled=bool(lr.get("enabled", False)),
                **{k: v for k, v in lr.items() if k != "enabled"})


def _layer_key(prefix: str, idx: int) -> str:
    """A dotted layer path and index to the block's key: ``transformer.h``
    and 3 give ``h_3``."""
    base = prefix.replace(".", "/").rstrip("/").split("/")[-1]
    return f"{base}_{idx}"


def _subtree(state: Dict[str, torch.Tensor], key: str) -> Dict[str, torch.Tensor]:
    """The leaves under top-level ``key`` by their key below it (``""`` for
    a top-level parameter such as ``wte``)."""
    dot = key + "."
    out = {k[len(dot):]: v for k, v in state.items() if k.startswith(dot)}
    if key in state:
        out[""] = state[key]
    return out


def student_initialization(student_state: Dict[str, torch.Tensor],
                           teacher_state: Dict[str, torch.Tensor],
                           deepspeed_config: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Seed a shallower student from the teacher: layer
    ``teacher_layer[i]`` of the teacher becomes layer ``i`` of the student,
    and each ``other_module_name`` subtree (embeddings, final norm) is
    copied. Returns a new state dict (copies of the teacher's tensors, the
    student's own where nothing is seeded); the student's unchanged when
    layer reduction is off."""
    lr = layer_reduction_config(deepspeed_config)
    if not lr["enabled"]:
        return student_state
    prefix = lr.get("module_name_prefix", "h")
    teacher_layer = [int(t) for t in lr.get("teacher_layer", [])]
    other = list(lr.get("other_module_name", []))

    out = dict(student_state)

    def seed(s_key: str, t_key: str, what: str) -> None:
        src, dst = _subtree(teacher_state, t_key), _subtree(student_state, s_key)
        if not src or not dst:
            raise KeyError(f"{what}: student[{s_key}] or teacher[{t_key}] missing (student keys: "
                           f"{sorted(student_state)[:8]}...)")
        src_shapes = {k: tuple(v.shape) for k, v in src.items()}
        if src_shapes != {k: tuple(v.shape) for k, v in dst.items()}:
            raise ValueError(f"{what}: teacher[{t_key}] and student[{s_key}] differ in structure")
        for k, v in src.items():
            out[f"{s_key}.{k}" if k else s_key] = v.detach().clone()

    for s_idx, t_idx in enumerate(teacher_layer):
        seed(_layer_key(prefix, s_idx), _layer_key(prefix, t_idx), "layer_reduction")
    for name in other:
        key = name.replace(".", "/").rstrip("/").split("/")[-1]
        seed(key, key, f"layer_reduction other_module_name {name!r}")
    logger.info(f"student_initialization: {len(teacher_layer) + len(other)} subtrees seeded "
                f"from the teacher (layers {teacher_layer} -> 0..{len(teacher_layer) - 1})")
    return out
