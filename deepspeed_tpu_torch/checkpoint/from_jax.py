"""Carry weights from the JAX package to the port.

``params_from_jax`` takes the JAX package's flax param tree of a GPT-2 or a
LLaMA-family model as nested dicts of numpy arrays
(``jax.device_get(engine.params)``) and returns the port's state dict. The
layouts are identical, so this is a renaming: ``h_0/attn/c_attn/kernel`` ->
``h_0.attn.c_attn.kernel``, ``ln_f/LayerNorm_0/scale`` -> ``ln_f.scale``,
``layers_0/self_attn/q_proj/kernel`` -> ``layers_0.self_attn.q_proj.kernel``.
``opt_state_from_jax`` does the same for the JAX ``fused_adam`` state, so that both packages can resume
from one mid-training state; ``params_to_jax`` goes the other way (the JAX
paths and numpy arrays of a port state dict, as the engine's
``save_16bit_model`` writes them). An MoE model's keys carry over the same way
(``h_1/moe/deepspeed_moe/gate/wg`` -> ``h_1.moe.deepspeed_moe.gate.wg``, the
experts' stacked ``[E, ...]`` leaves as they are), and the config inferred
from such a tree has its ``moe_num_experts``, ``moe_layer_freq`` and
``moe_use_residual``.
"""

from typing import Dict, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.models import gpt2, llama
from deepspeed_tpu_torch.models.common import flatten_tree
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.models.llama import LlamaConfig

ModelConfig = Union[GPT2Config, LlamaConfig]

#: flax's inner scope of ``nn.LayerNorm`` inside the model's LayerNorm wrapper
_FLAX_NORM_SCOPE = "LayerNorm_0"


def _to_tensor(leaf) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


#: the port's LayerNorm modules (``ln_1``, ``ln_2``, ``ln_f``), whose leaves
#: sit one flax scope deeper in the JAX tree
_NORM_PREFIX = "ln_"


def _torch_key(path: str) -> str:
    return ".".join(p for p in path.split("/") if p != _FLAX_NORM_SCOPE)


def _jax_path(key: str) -> str:
    """The inverse of :func:`_torch_key`."""
    parts = key.split(".")
    if len(parts) >= 2 and parts[-2].startswith(_NORM_PREFIX):
        parts.insert(len(parts) - 1, _FLAX_NORM_SCOPE)
    return "/".join(parts)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: its bits as uint16
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """State-dict key -> (shape, dtype) of the model family ``cfg`` builds."""
    return (llama if isinstance(cfg, LlamaConfig) else gpt2).param_shapes(cfg)


def _infer_llama_config(sd: Dict[str, torch.Tensor]) -> LlamaConfig:
    """A LLaMA tree's config as far as its shapes tell it. The context
    length, RoPE base, norm epsilon and sliding window leave no trace in the
    parameters and keep ``LlamaConfig``'s defaults: pass ``config=`` for a
    model that sets them."""
    q = sd.get("layers_0.self_attn.q_proj.kernel")
    if q is None or q.dim() != 3:
        raise KeyError("params_from_jax: no [E, H, D] layers_0/self_attn/q_proj/kernel to infer "
                       "the config from; pass config=")
    vocab, hidden = sd["embed_tokens"].shape
    return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                       intermediate_size=sd["layers_0.mlp.gate_proj.kernel"].shape[1],
                       num_hidden_layers=len({k.split(".")[0] for k in sd if k.startswith("layers_")}),
                       num_attention_heads=q.shape[1],
                       num_key_value_heads=sd["layers_0.self_attn.k_proj.kernel"].shape[1],
                       attention_bias="layers_0.self_attn.q_proj.bias" in sd,
                       param_dtype=sd["embed_tokens"].dtype)


def _infer_config(sd: Dict[str, torch.Tensor]) -> ModelConfig:
    if "embed_tokens" in sd:
        return _infer_llama_config(sd)
    n_layer = len({k.split(".")[0] for k in sd if k.startswith("h_")})
    vocab, n_embd = sd["wte"].shape
    qkv = sd.get("h_0.attn.c_attn.kernel")
    if qkv is None or qkv.dim() != 4:
        raise KeyError("params_from_jax: no [E, 3, H, D] h_0/attn/c_attn/kernel to infer the "
                       "config from; pass config=")
    moe = {}
    gates = {int(k.split(".")[0][2:]): v for k, v in sd.items()
             if k.startswith("h_") and k.endswith(".moe.deepspeed_moe.gate.wg")}
    if gates:
        # MoE blocks sit at layers freq - 1, 2 freq - 1, ...
        freq = min(gates) + 1
        expected = [i for i in range(n_layer) if i % freq == freq - 1]
        if sorted(gates) != expected:
            raise ValueError(f"params_from_jax: MoE blocks at layers {sorted(gates)} follow no "
                             f"moe_layer_freq; pass config=")
        moe = dict(moe_num_experts=gates[freq - 1].shape[1], moe_layer_freq=freq,
                   moe_use_residual=any(".moe.coefficient." in k for k in sd))
    return GPT2Config(vocab_size=vocab, n_positions=sd["wpe"].shape[0], n_embd=n_embd,
                      n_layer=n_layer, n_head=qkv.shape[2], param_dtype=sd["wte"].dtype, **moe)


def params_from_jax(tree: dict, config: Optional[ModelConfig] = None,
                    scales: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The port's state dict of a GPT-2 or a LLaMA-family model from a JAX
    param tree (the family read from ``config``, or from the tree: LLaMA's
    has ``embed_tokens``).

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
    (``h_0.ln_1.scale`` -> ``h_0/ln_1/LayerNorm_0/scale``), flat, on the
    host. A bf16 tensor comes back as its bits in a ``uint16`` array, the
    form the JAX package's npz files store bf16 in."""
    return {_jax_path(k): _to_numpy(v) for k, v in state_dict.items()}


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
