"""The ``compression_training`` block (counterpart of
``deepspeed_tpu/compression/config.py``): per technique
``shared_parameters`` and ``different_groups``, each group with its method
parameters and module-name patterns, and the layer-reduction and
knowledge-distillation blocks, with JAX's defaults."""

from typing import Any, Dict

COMPRESSION_TRAINING = "compression_training"

WEIGHT_QUANTIZATION = "weight_quantization"
ACTIVATION_QUANTIZATION = "activation_quantization"
SPARSE_PRUNING = "sparse_pruning"
ROW_PRUNING = "row_pruning"
HEAD_PRUNING = "head_pruning"
CHANNEL_PRUNING = "channel_pruning"
LAYER_REDUCTION = "layer_reduction"
KNOWLEDGE_DISTILLATION = "knowledge_distillation"

_KD_DEFAULTS: Dict[str, Any] = dict(
    enabled=False,
    kd_coef=0.5,           # weight of the logit term in the mixed loss
    temperature=2.0,       # softmax temperature; the term is scaled by T^2
    layerwise_coef=0.0,    # weight of the block-output MSE term
    schedule_offset=0,     # the step the KD terms switch on
    schedule_offset_end=2 ** 31 - 1,  # the step they switch off
)

SHARED_PARAMETERS = "shared_parameters"
DIFFERENT_GROUPS = "different_groups"

TECHNIQUES = (WEIGHT_QUANTIZATION, ACTIVATION_QUANTIZATION, SPARSE_PRUNING,
              ROW_PRUNING, HEAD_PRUNING, CHANNEL_PRUNING)

_SHARED_DEFAULTS: Dict[str, Dict[str, Any]] = {
    WEIGHT_QUANTIZATION: dict(enabled=False, quantizer_kernel=False, schedule_offset=0,
                              quantize_groups=1, quantize_verbose=False,
                              quantization_type="symmetric", rounding="nearest",
                              quantize_weight_in_forward=True,
                              fp16_mixed_quantize=False, quantize_change_ratio=0.001),
    ACTIVATION_QUANTIZATION: dict(enabled=False, quantization_type="symmetric",
                                  range_calibration="dynamic", schedule_offset=1000),
    SPARSE_PRUNING: dict(enabled=False, method="l1", schedule_offset=1000,
                         schedule_offset_end=1000, schedule_offset_stride=1,
                         block_pattern="4x1", dense_ratio=0.1, excluded_modules=[]),
    ROW_PRUNING: dict(enabled=False, method="l1", schedule_offset=1000),
    HEAD_PRUNING: dict(enabled=False, method="topk", schedule_offset=1000,
                       num_heads=None),
    CHANNEL_PRUNING: dict(enabled=False, method="l1", schedule_offset=1000),
}

_GROUP_PARAM_DEFAULTS: Dict[str, Dict[str, Any]] = {
    WEIGHT_QUANTIZATION: dict(start_bits=8, target_bits=8, quantization_period=1),
    ACTIVATION_QUANTIZATION: dict(bits=8),
    SPARSE_PRUNING: dict(dense_ratio=0.5),
    ROW_PRUNING: dict(dense_ratio=0.5),
    HEAD_PRUNING: dict(dense_ratio=0.5, num_heads=None),
    CHANNEL_PRUNING: dict(dense_ratio=0.5),
}


def get_compression_config(param_dict: Dict[str, Any]) -> Dict[str, Any]:
    """``compression_training`` normalised: technique -> {shared_parameters,
    different_groups: {name: {params, modules, related_modules}}}, plus
    ``layer_reduction`` (``enabled`` made a bool, the rest as given) and
    ``knowledge_distillation`` (over its defaults)."""
    block = param_dict.get(COMPRESSION_TRAINING, {}) or {}
    out: Dict[str, Any] = {}
    for tech in TECHNIQUES:
        tech_cfg = block.get(tech, {}) or {}
        shared = dict(_SHARED_DEFAULTS[tech])
        shared.update(tech_cfg.get(SHARED_PARAMETERS, {}) or {})
        groups: Dict[str, Any] = {}
        for gname, gcfg in (tech_cfg.get(DIFFERENT_GROUPS, {}) or {}).items():
            params = dict(_GROUP_PARAM_DEFAULTS[tech])
            params.update(gcfg.get("params", {}) or {})
            groups[gname] = dict(params=params,
                                 modules=list(gcfg.get("modules", ["*"])),
                                 related_modules=gcfg.get("related_modules"))
        out[tech] = {SHARED_PARAMETERS: shared, DIFFERENT_GROUPS: groups}
    lr = block.get(LAYER_REDUCTION, {}) or {}
    out[LAYER_REDUCTION] = dict(enabled=bool(lr.get("enabled", False)), **{
        k: v for k, v in lr.items() if k != "enabled"})
    kd_out = dict(_KD_DEFAULTS)
    kd_out.update(block.get(KNOWLEDGE_DISTILLATION, {}) or {})
    kd_out["enabled"] = bool(kd_out.get("enabled", False))
    out[KNOWLEDGE_DISTILLATION] = kd_out
    return out
