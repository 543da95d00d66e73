"""Compression training (counterpart of
``deepspeed_tpu/compression/compress.py``).

``CompressionSpec`` resolves the ``compression_training`` block against a
model's named parameters: a leaf is a candidate when it is floating point,
at least 2-D, and its JAX path (``checkpoint/from_jax.jax_paths``) ends in
``kernel`` or contains ``embedding`` or ``wte``; each group's module
patterns select among them on whole path segments (``h_1`` never matches
``h_10``), so both packages select the same leaves. Its ``transform`` is
one ``(params, step) -> params`` function over the selected leaves, each
technique gated on ``step >= schedule_offset``.

``init_compression`` installs that transform on an engine, which applies
it to the masters at every training ``forward`` and ``eval_batch`` (before
MoQ's, when both are on), seeds a layer-reduced student from the teacher
(``student_initialization``) and turns on knowledge distillation.
``redundancy_clean`` bakes the end state into a state dict;
``export_compressed`` writes JAX's deployment files
(``compressed_weights.npz`` with ``<jax path>.int8``, ``.scale`` and
``.shape`` for each quantized kernel, and ``compression_manifest.json``),
which ``load_compressed`` of either package reads.

The port's trees are state dicts (``module.state_dict()``): a block ``i``
sits under the key prefix ``h_{i}.`` where the JAX tree has a ``h_{i}``
subtree.
"""

import contextlib
import fnmatch
import inspect
import json
import logging
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.from_jax import _torch_key, jax_paths
from deepspeed_tpu_torch.compression import basic_layer as BL
from deepspeed_tpu_torch.compression.config import (CHANNEL_PRUNING, COMPRESSION_TRAINING,
                                                    DIFFERENT_GROUPS, HEAD_PRUNING,
                                                    KNOWLEDGE_DISTILLATION, LAYER_REDUCTION,
                                                    ROW_PRUNING, SHARED_PARAMETERS, SPARSE_PRUNING,
                                                    WEIGHT_QUANTIZATION, get_compression_config)
from deepspeed_tpu_torch.ops.quantizer.core import divisor_groups, quantize

logger = logging.getLogger(__name__)

#: the techniques that transform weights, in the order they apply
WEIGHT_TECHNIQUES = (WEIGHT_QUANTIZATION, SPARSE_PRUNING, ROW_PRUNING, HEAD_PRUNING, CHANNEL_PRUNING)
COMPRESSED_WEIGHTS = "compressed_weights.npz"
MANIFEST = "compression_manifest.json"


def layer_reduction_config(ds_config: Dict[str, Any]) -> Dict[str, Any]:
    """The ``compression_training.layer_reduction`` block as the JAX parse
    returns it: ``enabled`` made a bool, every other key as given."""
    return get_compression_config(ds_config or {})[LAYER_REDUCTION]


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


def _match(path: str, patterns: List[str]) -> bool:
    """Whether a slash-joined JAX path matches one of upstream's dotted
    module patterns, on whole segments (glob patterns as globs)."""
    bounded = "/" + path + "/"
    for pat in patterns:
        p = pat.replace(".", "/")
        if any(ch in p for ch in "*?["):
            if fnmatch.fnmatch(path, p) or fnmatch.fnmatch(bounded, f"*/{p}/*"):
                return True
        elif f"/{p}/" in bounded:
            return True
    return False


def _candidate(path: str, t: torch.Tensor) -> bool:
    """JAX's leaf rule: a floating matrix whose path ends in ``kernel`` or
    names an embedding (``embedding``, ``wte``)."""
    return (t.is_floating_point() and t.dim() >= 2
            and (path.endswith("kernel") or "embedding" in path or "wte" in path))


Rule = Tuple[str, Dict[str, Any], Dict[str, Any]]


class CompressionSpec:
    """The config resolved against named parameters: ``rules`` maps a
    parameter's name to its ``(technique, group params, shared params)``
    list, in the order they apply."""

    def __init__(self, config: Dict[str, Any], params: Dict[str, torch.Tensor]):
        self.config = config
        self.rules: Dict[str, List[Rule]] = {}
        n = 0
        paths = jax_paths(params)
        for tech in WEIGHT_TECHNIQUES:
            shared = config[tech][SHARED_PARAMETERS]
            if not shared.get("enabled", False):
                continue
            for group in config[tech][DIFFERENT_GROUPS].values():
                for name, leaf in params.items():
                    path = paths[name]
                    if _candidate(path, leaf) and _match(path, group["modules"]):
                        self.rules.setdefault(name, []).append((tech, group["params"], shared))
                        n += 1
        logger.info(f"compression: {n} (param, technique) rules across {len(self.rules)} params")

    def apply(self, params: Dict[str, torch.Tensor], step: int,
              grad_masks: bool = False):
        """The ruled leaves of ``params`` at ``step``: ``{name: tensor}``, and
        with ``grad_masks`` also ``{name: mask or None}``, the product of the
        active pruning masks, which is the transform's derivative (the
        quantization passes the gradient straight through)."""
        out, masks = {}, {}
        for name, rules in self.rules.items():
            leaf, gmask = params[name], None
            for tech, gp, shared in rules:
                offset = int(shared.get("schedule_offset", 0))
                if step < offset:
                    continue
                mask = None
                if tech == WEIGHT_QUANTIZATION:
                    bits = BL.scheduled_bits(step - offset, int(gp["start_bits"]), int(gp["target_bits"]),
                                             int(gp["quantization_period"]))
                    sym = shared.get("quantization_type", "symmetric") == "symmetric"
                    leaf = BL.qdq_weight(leaf, bits, groups=int(shared.get("quantize_groups", 1)),
                                         symmetric=sym)
                elif tech == SPARSE_PRUNING:
                    mask = BL.sparse_prune_mask(leaf, float(gp["dense_ratio"]), shared.get("method", "l1"))
                elif tech == ROW_PRUNING:
                    mask = BL.row_prune_mask(leaf, float(gp["dense_ratio"]))
                elif tech == HEAD_PRUNING:
                    heads = gp.get("num_heads") or shared.get("num_heads")
                    if heads:
                        mask = BL.head_prune_mask(leaf, float(gp["dense_ratio"]), int(heads))
                    else:
                        logger.warning(f"head_pruning on {name}: num_heads not set; skipped")
                else:
                    mask = BL.channel_prune_mask(leaf, float(gp["dense_ratio"]))
                if mask is not None:
                    leaf = leaf * mask
                    gmask = mask if gmask is None else gmask * mask
            out[name] = leaf
            masks[name] = gmask
        return (out, masks) if grad_masks else out

    def transform(self) -> Callable:
        """``(params, step) -> {name: tensor}`` over the ruled leaves."""
        return lambda params, step: self.apply(params, step)


def build_compression_transform(params: Dict[str, torch.Tensor],
                                ds_config: Dict[str, Any]) -> Optional[Callable]:
    """The spec's transform over ``params``; None when no rule applies."""
    spec = CompressionSpec(get_compression_config(ds_config), params)
    return spec.transform() if spec.rules else None


def _final_step(cfg: Dict[str, Any]) -> int:
    """Past every technique's offset, and past every quantization period
    (so that the bits reach ``target_bits``)."""
    return 1 + max(int(cfg[t][SHARED_PARAMETERS].get("schedule_offset", 0))
                   for t in WEIGHT_TECHNIQUES) + 10 ** 9


def redundancy_clean(params: Dict[str, torch.Tensor], deepspeed_config: Dict[str, Any],
                     step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``params`` with the compression's end state baked in (a new state
    dict; the unruled leaves as they are). ``step`` defaults to past every
    offset and every quantization period."""
    cfg = get_compression_config(deepspeed_config)
    spec = CompressionSpec(cfg, params)
    if not spec.rules:
        return params
    with torch.no_grad():
        return {**params, **spec.apply(params, _final_step(cfg) if step is None else int(step))}


def _save_flat_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    """JAX's npz layout: its keys as given, the ``__dtypes__`` map."""
    dtypes = {k: str(v.dtype) for k, v in flat.items()}
    with open(path, "wb") as f:  # a file object: np.savez appends no ".npz"
        np.savez(f, __dtypes__=np.frombuffer(json.dumps(dtypes).encode(), np.uint8), **flat)


def export_compressed(params: Dict[str, torch.Tensor], deepspeed_config: Dict[str, Any],
                      output_dir: str) -> str:
    """Write the deployment files of ``params`` compressed by the config:
    pruning baked in, every weight-quantized kernel of at most 8 target
    bits stored as int8 codes with per-group fp32 scales (groups of about
    2048 elements) and its shape, the rest fp32, all under JAX paths.
    Returns the npz path."""
    cleaned = redundancy_clean(params, deepspeed_config)
    spec = CompressionSpec(get_compression_config(deepspeed_config), params)
    target_bits = {n: int(gp["target_bits"]) for n, rules in spec.rules.items()
                   for t, gp, _ in rules if t == WEIGHT_QUANTIZATION}
    out = {}
    paths = jax_paths(cleaned)
    for name, t in cleaned.items():
        path = paths[name]
        arr = t.detach().float().cpu() if t.is_floating_point() else t.detach().cpu()
        if name in target_bits and target_bits[name] <= 8:
            q, qp = quantize(arr, num_bits=8, symmetric=True,
                             num_groups=divisor_groups(arr.numel(), 2048))
            out[path + ".int8"] = q.numpy()
            out[path + ".scale"] = qp.scale.numpy().astype(np.float32)
            out[path + ".shape"] = np.asarray(arr.shape, np.int64)
        else:
            out[path] = arr.numpy()
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, COMPRESSED_WEIGHTS)
    _save_flat_npz(out_path, out)
    with open(os.path.join(output_dir, MANIFEST), "w") as f:
        json.dump({"int8_params": sorted(paths[n] for n in target_bits)}, f, indent=2)
    return out_path


def load_compressed(path: str) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`export_compressed` (of either package): a state
    dict of fp32 CPU tensors, each int8 triplet dequantised."""
    if os.path.isdir(path):
        path = os.path.join(path, COMPRESSED_WEIGHTS)
    with np.load(path) as z:
        flat = {k: np.array(z[k]) for k in z.files if k != "__dtypes__"}
    out = {}
    for k, v in flat.items():
        if k.endswith(".int8"):
            base = k[:-len(".int8")]
            scale = flat[base + ".scale"]
            shape = tuple(int(x) for x in flat[base + ".shape"])
            vals = (v.astype(np.float32).reshape(scale.shape[0], -1)
                    * scale.reshape(scale.shape[0], -1))
            out[_torch_key(base)] = torch.from_numpy(vals.reshape(shape))
        elif not (k.endswith(".scale") or k.endswith(".shape")):
            out[_torch_key(k)] = torch.from_numpy(v)
    return out


def init_compression(model_or_engine, deepspeed_config: Optional[Dict[str, Any]] = None,
                     teacher_model=None, mpu=None):
    """Install compression training on an engine before its first step;
    returns the engine. ``deepspeed_config`` defaults to the engine's own
    config. ``teacher_model`` is a port ``nn.Module`` on the engine's
    device, or a ``(module, state_dict)`` pair whose tensors run in the
    module's place (the port's form of JAX's ``(module, params)``). It is
    required by ``layer_reduction`` (the student's layers are seeded from
    it) and by ``knowledge_distillation`` (it runs under ``no_grad`` beside
    the student's forward inside the KD window). ``mpu`` is taken for
    upstream's signature; one card has no model parallelism."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    if not isinstance(model_or_engine, DeepSpeedEngine):
        raise TypeError("init_compression expects a DeepSpeedEngine; for a state dict use "
                        "build_compression_transform(params, ds_config)")
    engine = model_or_engine
    if engine.global_steps > 0:
        raise RuntimeError("init_compression must run before the first train_batch "
                           "(rebuilding the step mid-run would discard live optimizer side-state)")
    raw = (deepspeed_config if isinstance(deepspeed_config, dict)
           else {COMPRESSION_TRAINING: engine.config.compression_config})
    cfg = get_compression_config(raw)
    lr, kd = cfg[LAYER_REDUCTION], cfg[KNOWLEDGE_DISTILLATION]
    if (lr["enabled"] or kd["enabled"]) and teacher_model is None:
        raise ValueError("Teacher model is required for layer reduction / knowledge distillation")
    offload_optimizer = engine.config.zero_config.offload_optimizer_device != "none"
    if kd["enabled"] and offload_optimizer:
        raise ValueError("knowledge_distillation requires the fused train_batch path; "
                         "offload_optimizer and 1-bit/0-1 Adam schedules never reach the KD gate")
    spec = CompressionSpec(cfg, dict(engine.module.named_parameters()))
    if spec.rules and engine._param_offload:
        raise ValueError("compression-in-forward does not compose with offload_param "
                         "(masks/quantization would apply to host-resident leaves); disable one "
                         "of the two")
    if spec.rules and offload_optimizer:
        # JAX runs the offloaded steps uncompressed, with a warning
        raise ValueError("compression-in-forward does not compose with offload_optimizer: the "
                         "JAX engine runs those steps uncompressed; disable one of the two")
    if teacher_model is not None and (lr["enabled"] or kd["enabled"]):
        t_module, t_params = _resolve_teacher(teacher_model, engine)
        if lr["enabled"]:
            teacher_state = t_params if t_params is not None else t_module.state_dict()
            seeded = student_initialization(engine.module.state_dict(), teacher_state, raw)
            engine.module.load_state_dict(seeded)
            for name, _ in engine.module.named_parameters():
                engine.refresh_host_master(name)
        if kd["enabled"]:
            engine._kd_config = dict(kd, module=t_module, params=t_params,
                                     teacher_layer=(list(lr.get("teacher_layer") or [])
                                                    if lr["enabled"] else []))
            logger.info(f"knowledge distillation active: kd_coef={kd['kd_coef']} "
                        f"T={kd['temperature']} layerwise={kd['layerwise_coef']} steps "
                        f"[{kd['schedule_offset']}, {kd['schedule_offset_end']})")
    engine._install_compression(spec if spec.rules else None)
    return engine


def _resolve_teacher(teacher_model, engine):
    """``(module, state dict on the engine's device or None)``."""
    module, state = (teacher_model if isinstance(teacher_model, tuple) else (teacher_model, None))
    if not isinstance(module, torch.nn.Module):
        raise TypeError(f"teacher_model must be a torch module or a (module, state_dict) pair, "
                        f"got {type(module).__name__}")
    device = getattr(module, "device", None)
    if device is not None and torch.device(device) != engine.device:
        raise ValueError(f"the teacher lives on {device} but the engine runs on {engine.device}")
    if state is not None:
        state = {k: torch.as_tensor(v).to(engine.device) for k, v in state.items()}
    return module, state


def _block_names(module: torch.nn.Module, kd: dict) -> List[str]:
    """The module's numbered blocks (``h_3``, ``layers_3``...: the KD
    block's ``block_prefix``, else the module's ``streamed_block_prefixes``),
    in the order of their numbers."""
    prefixes = kd.get("block_prefix") or getattr(module, "streamed_block_prefixes", ("h_",))
    if isinstance(prefixes, str):
        prefixes = (prefixes,)
    pats = [re.compile(re.escape(p) + r"\d+") for p in prefixes]
    names = [n for n, _ in module.named_children() if any(p.fullmatch(n) for p in pats)]
    return sorted(names, key=lambda n: int(n.rsplit("_", 1)[-1]))


@contextlib.contextmanager
def _capture(module: torch.nn.Module, names: List[str], into: Dict[str, torch.Tensor]):
    """Forward hooks that keep each named block's first output (``x`` of an
    ``(x, aux)`` pair) for the duration of the ``with``."""

    def hook(name):
        def keep(_mod, _args, out):
            if name not in into:
                into[name] = out[0] if isinstance(out, (tuple, list)) else out
        return keep

    handles = [getattr(module, n).register_forward_hook(hook(n)) for n in names]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _accepted(module: torch.nn.Module) -> set:
    return set(inspect.signature(type(module).forward).parameters)


def distillation_loss(engine, kd: dict, mb: dict, kwargs: dict) -> torch.Tensor:
    """The training loss inside the KD window (JAX ``_apply_kd``): ``(1 -
    a) CE + a KL + lw MSE``, with ``a = kd_coef``, the KL Hinton's at
    temperature T scaled by T^2 (mean over positions), and the MSE the mean
    over student blocks of each block output's mean squared difference to
    its teacher block's (student block i against the teacher's
    ``teacher_layer[i]`` under layer reduction, else its i-th)."""
    ids = mb["input_ids"]
    temp, lw, coef = float(kd["temperature"]), float(kd["layerwise_coef"]), float(kd["kd_coef"])
    t_module, t_params = kd["module"], kd["params"]
    s_caps, t_caps = {}, {}
    s_names = _block_names(engine.module, kd) if lw > 0.0 else []
    with _capture(engine.module, s_names, s_caps):
        outputs = engine._run_module(ids, **kwargs)
    ce = engine.loss_fn(outputs, mb)
    accepts = _accepted(t_module)
    t_kwargs = {k: v for k, v in engine._module_kwargs(mb).items() if k in accepts}
    if "deterministic" in accepts:
        t_kwargs["deterministic"] = True
    t_names = _block_names(t_module, kd) if lw > 0.0 else []
    with torch.no_grad(), _capture(t_module, t_names, t_caps):
        t_out = (t_module(ids, **t_kwargs) if t_params is None
                 else torch.func.functional_call(t_module, t_params, (ids,), t_kwargs))
    s_logits = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
    t_logits = (t_out[0] if isinstance(t_out, (tuple, list)) else t_out).float()
    s = s_logits.float() / temp
    t = t_logits / temp
    kl = (torch.softmax(t, dim=-1) * (torch.log_softmax(t, dim=-1)
                                      - torch.log_softmax(s, dim=-1))).sum(dim=-1)
    kd_kl = kl.mean() * (temp * temp)
    mse = torch.zeros((), dtype=torch.float32, device=ce.device)
    if lw > 0.0:
        if kd["teacher_layer"]:
            pairs = [t_names[int(i)] for i in kd["teacher_layer"][:len(s_names)]]
        else:
            if len(t_names) < len(s_names):
                raise ValueError(f"layerwise KD: teacher has {len(t_names)} blocks for "
                                 f"{len(s_names)} student blocks and no layer_reduction "
                                 f"teacher_layer mapping; provide one")
            pairs = t_names[:len(s_names)]
        for s_name, t_name in zip(s_names, pairs):
            mse = mse + torch.mean(torch.square(s_caps[s_name].float() - t_caps[t_name].float()))
        mse = mse / max(len(s_names), 1)
    return (1.0 - coef) * ce + coef * kd_kl + lw * mse
