"""Carry weights from the JAX package to the port.

``params_from_jax`` takes the JAX package's flax param tree of a GPT-2, a
LLaMA-family or a BERT model, a decoder family (GPT-NeoX, GPT-J, GPT-Neo,
OPT, Falcon, BLOOM), a ``DeepSpeedTransformerLayer`` or a
``TiledLinear``, as nested dicts of numpy arrays
(``jax.device_get(engine.params)``) and returns the port's state dict. The
layouts are identical, so this is a renaming: ``h_0/attn/c_attn/kernel`` ->
``h_0.attn.c_attn.kernel``, ``ln_f/LayerNorm_0/scale`` -> ``ln_f.scale``,
``layers_0/self_attn/q_proj/kernel`` -> ``layers_0.self_attn.q_proj.kernel``,
``bert/layer_0/attention_ln/LayerNorm_0/scale`` ->
``bert.layer_0.attention_ln.scale``, ``layer/attn_qkv/kernel`` ->
``layer.attn_qkv.kernel``, ``tile_0_1_kernel`` as it is. The decoder
families' norms are flax ``nn.LayerNorm``s with no wrapper scope
(``layers_0/input_layernorm/scale`` -> ``layers_0.input_layernorm.scale``,
GPT-J's ``h_0/ln_1/scale`` -> ``h_0.ln_1.scale``).
``opt_state_from_jax`` does the same for the JAX ``fused_adam`` state, so that both packages can resume
from one mid-training state; ``params_to_jax`` goes the other way (the JAX
paths and numpy arrays of a port state dict, as the engine's
``save_16bit_model`` writes them). An MoE model's keys carry over the same way
(``h_1/moe/deepspeed_moe/gate/wg`` -> ``h_1.moe.deepspeed_moe.gate.wg``, the
experts' stacked ``[E, ...]`` leaves as they are), and the config inferred
from such a tree has its ``moe_num_experts``, ``moe_layer_freq`` and (GPT-2)
``moe_use_residual``. A Mixtral tree (``layers_0/moe/deepspeed_moe/experts/
deepspeed_experts/gate_proj/kernel [E, H, I]``, the gate ``.../gate/wg [H,
E]``) carries over the same way; its ``moe_k`` is not in the tree and keeps
``LlamaConfig``'s default, Mixtral's 2.
"""

from typing import Dict, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.models import bert, gpt2, llama
from deepspeed_tpu_torch.models.bert import BertConfig
from deepspeed_tpu_torch.models.bloom import BloomConfig, BloomForCausalLM
from deepspeed_tpu_torch.models.common import flatten_tree
from deepspeed_tpu_torch.models.falcon import FalconConfig, FalconForCausalLM
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoForCausalLM
from deepspeed_tpu_torch.models.gpt_neox import GPTNeoXConfig, GPTNeoXForCausalLM
from deepspeed_tpu_torch.models.gptj import GPTJConfig, GPTJForCausalLM
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
from deepspeed_tpu_torch.ops.transformer import transformer
from deepspeed_tpu_torch.ops.transformer.transformer import DeepSpeedTransformerConfig

ModelConfig = Union[GPT2Config, LlamaConfig, BertConfig, DeepSpeedTransformerConfig, GPTNeoXConfig,
                    GPTJConfig, GPTNeoConfig, OPTConfig, FalconConfig, BloomConfig]

#: the decoder families: config type -> model class
FAMILIES = {GPTNeoXConfig: GPTNeoXForCausalLM, GPTJConfig: GPTJForCausalLM,
            GPTNeoConfig: GPTNeoForCausalLM, OPTConfig: OPTForCausalLM,
            FalconConfig: FalconForCausalLM, BloomConfig: BloomForCausalLM}

#: flax's inner scope of ``nn.LayerNorm`` inside the model's LayerNorm wrapper
_FLAX_NORM_SCOPE = "LayerNorm_0"


def _to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):  # e.g. zero_to_fp32.load_state_dict_from_npz's leaves
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


#: the port's LayerNorm wrappers (GPT-2's ``ln_1``, ``ln_2``, ``ln_f``;
#: BERT's ``attention_ln``, ``output_ln``, ``embeddings_ln``,
#: ``transform_ln``), whose leaves sit one flax scope deeper in the JAX tree.
#: A bare flax ``nn.LayerNorm`` (the encoder layer's ``attn_norm``) has none.
_NORM_PREFIX = "ln_"
_NORM_SUFFIX = "_ln"


def _torch_key(path: str) -> str:
    return ".".join(p for p in path.split("/") if p != _FLAX_NORM_SCOPE)


def _jax_path(key: str, wrapped: bool) -> str:
    """The inverse of :func:`_torch_key`; ``wrapped`` for a tree whose norms
    sit in a wrapper scope (GPT-2's and BERT's). Callers take ``wrapped``
    from :func:`jax_paths`, which reads it from the whole state dict."""
    parts = key.split(".")
    if wrapped and len(parts) >= 2 and (parts[-2].startswith(_NORM_PREFIX)
                                        or parts[-2].endswith(_NORM_SUFFIX)):
        parts.insert(len(parts) - 1, _FLAX_NORM_SCOPE)
    return "/".join(parts)


def _family_type(sd) -> Optional[type]:
    """The config type of a decoder family's state dict, read from the keys
    only that family has (GPT-NeoX's ``embed_in``, BLOOM's
    ``word_embeddings_layernorm`` beside Falcon's ``word_embeddings``, OPT's
    ``embed_positions``, GPT-J's ``lm_head`` beside the ``h_<i>.attn.q_proj``
    that GPT-Neo has without it), or None for any other model."""
    if "embed_in" in sd:
        return GPTNeoXConfig
    if "word_embeddings" in sd:
        return BloomConfig if "word_embeddings_layernorm.scale" in sd else FalconConfig
    if "embed_positions" in sd:
        return OPTConfig
    if any(k.startswith("h_") and k.endswith(".attn.q_proj.kernel") for k in sd):
        return GPTJConfig if "lm_head.kernel" in sd else GPTNeoConfig
    return None


def jax_paths(state_dict) -> Dict[str, str]:
    """``{key: JAX path}`` of a port state dict (or of its names), the one
    place that decides whether the norms sit in flax's ``LayerNorm_0``
    scope: GPT-2's and BERT's do, a decoder family's
    (:func:`_family_type`) do not (GPT-J's ``h_0.ln_1.scale`` ->
    ``h_0/ln_1/scale``, GPT-2's -> ``h_0/ln_1/LayerNorm_0/scale``)."""
    wrapped = _family_type(state_dict) is None
    return {k: _jax_path(k, wrapped) for k in state_dict}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: its bits as uint16
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def param_shapes(cfg) -> Dict[str, tuple]:
    """State-dict key -> (shape, dtype) of the model ``cfg`` builds, or of a
    module given in its place (a ``TiledLinear``: its own state dict)."""
    if isinstance(cfg, torch.nn.Module):
        return {k: (tuple(v.shape), v.dtype) for k, v in cfg.state_dict().items()}
    if type(cfg) in FAMILIES:  # the model's own skeleton, built on no device
        return param_shapes(FAMILIES[type(cfg)](cfg, device="meta"))
    family = {LlamaConfig: llama, BertConfig: bert, DeepSpeedTransformerConfig: transformer}
    return family.get(type(cfg), gpt2).param_shapes(cfg)


_MOE_GATE = ".moe.deepspeed_moe.gate.wg"
_MOE_EXPERTS = ".moe.deepspeed_moe.experts.deepspeed_experts."


def _infer_moe(sd: Dict[str, torch.Tensor], prefix: str, n_layer: int) -> dict:
    """``moe_num_experts`` and ``moe_layer_freq`` from the gates' shapes and
    layers (MoE layers sit at freq - 1, 2 freq - 1, ...); {} for a dense
    tree."""
    gates = {int(k.split(".")[0][len(prefix):]): v for k, v in sd.items()
             if k.startswith(prefix) and k.endswith(_MOE_GATE)}
    if not gates:
        return {}
    freq = min(gates) + 1
    expected = [i for i in range(n_layer) if i % freq == freq - 1]
    if sorted(gates) != expected:
        raise ValueError(f"params_from_jax: MoE blocks at layers {sorted(gates)} follow no "
                         f"moe_layer_freq; pass config=")
    return dict(moe_num_experts=gates[freq - 1].shape[1], moe_layer_freq=freq)


def _infer_llama_config(sd: Dict[str, torch.Tensor]) -> LlamaConfig:
    """A LLaMA tree's config as far as its shapes tell it. The context
    length, RoPE base, norm epsilon, sliding window and top-k leave no trace
    in the parameters and keep ``LlamaConfig``'s defaults: pass ``config=``
    for a model that sets them."""
    q = sd.get("layers_0.self_attn.q_proj.kernel")
    if q is None or q.dim() != 3:
        raise KeyError("params_from_jax: no [E, H, D] layers_0/self_attn/q_proj/kernel to infer "
                       "the config from; pass config=")
    vocab, hidden = sd["embed_tokens"].shape
    n_layer = len({k.split(".")[0] for k in sd if k.startswith("layers_")})
    moe = _infer_moe(sd, "layers_", n_layer)
    if moe:
        first = moe["moe_layer_freq"] - 1
        intermediate = sd[f"layers_{first}{_MOE_EXPERTS}gate_proj.kernel"].shape[2]
    else:
        intermediate = sd["layers_0.mlp.gate_proj.kernel"].shape[1]
    return LlamaConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=intermediate,
                       num_hidden_layers=n_layer, num_attention_heads=q.shape[1],
                       num_key_value_heads=sd["layers_0.self_attn.k_proj.kernel"].shape[1],
                       attention_bias="layers_0.self_attn.q_proj.bias" in sd,
                       param_dtype=sd["embed_tokens"].dtype, **moe)


def _infer_bert_config(sd: Dict[str, torch.Tensor]) -> BertConfig:
    """A BERT tree's config as far as its shapes tell it (the activation,
    norm epsilon and dropout keep ``BertConfig``'s defaults)."""
    vocab, hidden = sd["bert.word_embeddings"].shape
    q = sd["bert.layer_0.attention.query.kernel"]
    return BertConfig(vocab_size=vocab, hidden_size=hidden,
                      num_hidden_layers=len({k.split(".")[1] for k in sd if k.startswith("bert.layer_")}),
                      num_attention_heads=q.shape[1],
                      intermediate_size=sd["bert.layer_0.intermediate.kernel"].shape[1],
                      max_position_embeddings=sd["bert.position_embeddings"].shape[0],
                      type_vocab_size=sd["bert.token_type_embeddings"].shape[0],
                      param_dtype=sd["bert.word_embeddings"].dtype)


def _infer_layer_config(sd: Dict[str, torch.Tensor]) -> DeepSpeedTransformerConfig:
    """A ``DeepSpeedTransformerLayer`` tree's config (its widths; the norm
    placement and ratios keep the defaults)."""
    hidden, _, heads, _ = sd["layer.attn_qkv.kernel"].shape
    return DeepSpeedTransformerConfig(hidden_size=hidden, heads=heads,
                                      intermediate_size=sd["layer.inter.kernel"].shape[1],
                                      param_dtype=sd["layer.attn_qkv.kernel"].dtype)


def _n_layers(sd: Dict[str, torch.Tensor], prefix: str) -> int:
    return len({k.split(".")[0] for k in sd if k.startswith(prefix)})


def _infer_family_config(sd: Dict[str, torch.Tensor]) -> Optional[ModelConfig]:
    """A decoder family's config as far as its tree's shapes tell it, or
    None for a tree of no decoder family. What leaves no trace in the
    parameters keeps the config's default: the context length (but GPT-Neo's
    and OPT's, from their position tables), GPT-NeoX's ``rotary_pct`` and
    ``use_parallel_residual``, GPT-J's ``rotary_dim``, GPT-Neo's
    ``window_size``, the norm epsilons and RoPE bases: pass ``config=`` for
    a model that sets them. (OPT's ``do_layer_norm_before`` is read from its
    final norm, which pre-LN models alone have.)"""
    family = _family_type(sd)
    if family is GPTNeoXConfig:
        vocab, e = sd["embed_in"].shape
        qkv = sd["layers_0.attention.query_key_value.kernel"]
        return GPTNeoXConfig(vocab_size=vocab, hidden_size=e, num_attention_heads=qkv.shape[1],
                             intermediate_size=sd["layers_0.dense_h_to_4h.kernel"].shape[1],
                             num_hidden_layers=_n_layers(sd, "layers_"), param_dtype=qkv.dtype)
    if family in (BloomConfig, FalconConfig):
        vocab, e = sd["word_embeddings"].shape
        qkv = sd["h_0.self_attention.query_key_value.kernel"]
        if family is BloomConfig:
            return BloomConfig(vocab_size=vocab, hidden_size=e, n_head=qkv.shape[1],
                               n_layer=_n_layers(sd, "h_"), param_dtype=qkv.dtype)
        kv, g = qkv.shape[1], qkv.shape[2] - 2
        return FalconConfig(vocab_size=vocab, hidden_size=e, num_attention_heads=kv * g,
                            num_kv_heads=kv, num_hidden_layers=_n_layers(sd, "h_"),
                            new_decoder_architecture="h_0.ln_attn.scale" in sd, param_dtype=qkv.dtype)
    if family is OPTConfig:
        vocab, embed = sd["embed_tokens"].shape
        q = sd["layers_0.self_attn.q_proj.kernel"]
        e = q.shape[0]
        return OPTConfig(vocab_size=vocab, hidden_size=e, num_attention_heads=q.shape[1],
                         ffn_dim=sd["layers_0.fc1.kernel"].shape[1], num_hidden_layers=_n_layers(sd, "layers_"),
                         max_position_embeddings=sd["embed_positions"].shape[0] - 2,
                         word_embed_proj_dim=embed if embed != e else None,
                         do_layer_norm_before="final_layer_norm.scale" in sd, param_dtype=q.dtype)
    if family in (GPTJConfig, GPTNeoConfig):
        vocab, e = sd["wte"].shape
        q = sd["h_0.attn.q_proj.kernel"]
        if family is GPTJConfig:
            return GPTJConfig(vocab_size=vocab, hidden_size=e, num_attention_heads=q.shape[1],
                              intermediate_size=sd["h_0.fc_in.kernel"].shape[1],
                              num_hidden_layers=_n_layers(sd, "h_"), param_dtype=q.dtype)
        return GPTNeoConfig(vocab_size=vocab, hidden_size=e, num_attention_heads=q.shape[1],
                            intermediate_size=sd["h_0.c_fc.kernel"].shape[1],
                            num_hidden_layers=_n_layers(sd, "h_"),
                            max_position_embeddings=sd["wpe"].shape[0], param_dtype=q.dtype)
    return None


def _infer_config(sd: Dict[str, torch.Tensor]) -> ModelConfig:
    family = _infer_family_config(sd)
    if family is not None:
        return family
    if "embed_tokens" in sd:
        return _infer_llama_config(sd)
    if "bert.word_embeddings" in sd:
        return _infer_bert_config(sd)
    if "layer.attn_qkv.kernel" in sd:
        return _infer_layer_config(sd)
    n_layer = len({k.split(".")[0] for k in sd if k.startswith("h_")})
    vocab, n_embd = sd["wte"].shape
    qkv = sd.get("h_0.attn.c_attn.kernel")
    if qkv is None or qkv.dim() != 4:
        raise KeyError("params_from_jax: no [E, 3, H, D] h_0/attn/c_attn/kernel to infer the "
                       "config from; pass config=")
    moe = _infer_moe(sd, "h_", n_layer)
    if moe:
        moe["moe_use_residual"] = any(".moe.coefficient." in k for k in sd)
    return GPT2Config(vocab_size=vocab, n_positions=sd["wpe"].shape[0], n_embd=n_embd,
                      n_layer=n_layer, n_head=qkv.shape[2], param_dtype=sd["wte"].dtype, **moe)


def params_from_jax(tree: dict, config: Optional[ModelConfig] = None,
                    scales: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The port's state dict of a model from a JAX param tree (the family
    read from ``config``, or from the tree: LLaMA's has ``embed_tokens``,
    BERT's ``bert/word_embeddings``, the encoder layer's
    ``layer/attn_qkv/kernel``, GPT-NeoX's ``embed_in``, OPT's
    ``embed_positions``, BLOOM's ``word_embeddings_layernorm`` and Falcon's
    ``word_embeddings`` without it, GPT-J's ``lm_head`` beside
    ``h_0/attn/q_proj``, GPT-Neo's ``h_0/attn/q_proj`` without it:
    :func:`_family_type`; a ``TiledLinear`` is passed as ``config``
    itself, the module the weights are for).

    ``scales`` is the ``"quant"`` mirror tree of a quantized tree (JAX
    ``quantize_params`` output); its ``kernel_scale`` leaves join the state
    dict beside their kernels, and ``config`` must then name the served
    weight dtype. Without ``config`` it is inferred from the tree (fp).
    Raises ``KeyError`` on a missing or extra key and ``ValueError`` on a
    shape mismatch."""
    sd = {_torch_key(path): _to_tensor(leaf) for path, leaf in flatten_tree(tree, "/").items()}
    if scales is not None:
        if config is None:
            raise ValueError("params_from_jax: a quantized tree needs config= (its "
                             "serve_weight_dtype and group size)")
        sd.update({_torch_key(path): _to_tensor(leaf)
                   for path, leaf in flatten_tree(scales, "/").items()})
    cfg = config if config is not None else _infer_config(sd)
    expected = param_shapes(cfg)
    missing = sorted(set(expected) - set(sd))
    extra = sorted(set(sd) - set(expected))
    if missing or extra:
        raise KeyError(f"params_from_jax: missing {missing[:8]}{'...' if len(missing) > 8 else ''}, "
                       f"extra {extra[:8]}{'...' if len(extra) > 8 else ''}")
    bad = [f"{k}: {tuple(sd[k].shape)} vs {shape}" for k, (shape, _) in expected.items()
           if tuple(sd[k].shape) != shape]
    if bad:
        raise ValueError("params_from_jax: shape mismatch — " + "; ".join(bad[:8]))
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: ``{JAX path: numpy array}``
    (GPT-2's ``h_0.ln_1.scale`` -> ``h_0/ln_1/LayerNorm_0/scale``, by
    :func:`jax_paths`), flat, on the host. A bf16 tensor comes back as its bits in a ``uint16`` array, the
    form the JAX package's npz files store bf16 in."""
    return {path: _to_numpy(state_dict[k]) for k, path in jax_paths(state_dict).items()}


def opt_state_from_jax(adam_state) -> dict:
    """The port's optimizer state (``FusedAdam.load_named_state``) from a
    JAX ``AdamState(count, exp_avg, exp_avg_sq)`` of numpy leaves, keyed
    like :func:`params_from_jax`: ``{"count": int, "exp_avg": {key:
    tensor}, "exp_avg_sq": {key: tensor}}``."""
    count, exp_avg, exp_avg_sq = adam_state
    return {"count": int(np.asarray(count)),
            "exp_avg": {_torch_key(k): _to_tensor(v) for k, v in flatten_tree(exp_avg, "/").items()},
            "exp_avg_sq": {_torch_key(k): _to_tensor(v)
                           for k, v in flatten_tree(exp_avg_sq, "/").items()}}
