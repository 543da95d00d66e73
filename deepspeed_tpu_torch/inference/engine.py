"""InferenceEngine: full-sequence forward, lockstep KV-cache generation and
beam search (counterpart of ``deepspeed_tpu/inference/engine.py``).

Kernel injection rebuilds the model with the serving dtype and, with
``use_flash_prefill``, the ``"flash"`` attention backend: K1 for
``forward`` and K3 for every cached decode step (a model class that sets
``xla_attention_reason``, BLOOM, keeps ``"xla"``). The rebuilt module is a skeleton on the
meta device that takes the caller's tensors as they are where their dtype
is the serving dtype, so injection holds one copy of the weights; JAX's
rebuilt flax module holds none. ``generate`` runs a
chunked prefill (``PREFILL_CHUNK`` tokens per call plus single-token
remainders) and then a Python token loop, where the JAX engine ran one
``lax.while_loop`` on the device; capturing the loop in a CUDA graph is
later work. ``num_beams > 1`` runs beam search over the same steps: the
cache is replicated to ``[batch * beams, ...]`` once after prefill and
reindexed by the winning beams every step. An MoE model (GPT-2 with
``moe_num_experts``, Mixtral) serves with eval-mode gating (the eval
capacity factor, no noise, no RTS); its ``(logits, aux_loss)`` output is
unwrapped to the logits on ``forward`` and on every cached step, as the JAX
engine's ``_unwrap_logits`` does.

Weights come from the model, from ``params=`` (a state dict) or from
``config.checkpoint`` (:func:`_load_checkpoint_params`). With
``dtype="int8"`` or an enabled ``quant`` block the engine holds int8 codes
and scales (``runtime/weight_quantizer.py``) in place of each quantized
weight, and dequantizes them to the serving dtype inside each call
(:meth:`InferenceEngine._mparams`, through ``torch.func.functional_call``),
as JAX's ``_mparams`` does in-graph. Tensor parallelism and
encoder-decoder models are later slices.
"""

import dataclasses
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import (WEIGHTS_NAME,
                                                         get_fp32_state_dict_from_zero_checkpoint,
                                                         load_state_dict_from_npz)
from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models.common import init_cache
from deepspeed_tpu_torch.runtime.weight_quantizer import WeightQuantization, dequantize_tree

logger = logging.getLogger(__name__)

#: the lockstep cache's per-row leaves, which beam search fans out and
#: reindexes; every other leaf (the host write counters) is shared
BEAM_CACHE_LEAVES = ("cached_key", "cached_value", "cached_key_scale", "cached_value_scale")


def _load_checkpoint_params(spec, base_dir: str = "", model_config=None) -> Dict[str, torch.Tensor]:
    """The serving weights ``config.checkpoint`` names, as a state dict
    (JAX ``inference/engine.py:36-71``): a consolidated ``.npz``
    (``save_16bit_model`` or ``zero_to_fp32`` output, from either package;
    read through ``params_from_jax`` against ``model_config``), an engine
    ``save_checkpoint`` directory (``latest`` or a tag: its fp32
    parameters, consolidated on the fly), a directory holding the npz, or a
    dict ``{"checkpoint_dir"|"path": ..., "tag": ...}``."""
    tag, original = None, spec
    if isinstance(spec, dict):
        tag = spec.get("tag")
        spec = spec.get("checkpoint_dir") or spec.get("path")
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"unsupported checkpoint spec {original!r}: pass a .npz path, an "
                         f"engine checkpoint dir, or {{'checkpoint_dir': ..., 'tag': ...}}")
    path = os.path.join(base_dir, spec) if base_dir else spec
    if path.endswith(".npz"):
        if not os.path.isfile(path):
            raise ValueError(f"checkpoint npz {path!r} does not exist")
        params = params_from_jax(load_state_dict_from_npz(path), model_config)
    elif os.path.isdir(path) and (tag is not None or os.path.exists(os.path.join(path, "latest"))):
        params = get_fp32_state_dict_from_zero_checkpoint(path, tag=tag)
    elif os.path.isdir(path) and os.path.isfile(os.path.join(path, WEIGHTS_NAME)):
        params = params_from_jax(load_state_dict_from_npz(path), model_config)
    else:
        raise ValueError(f"checkpoint path {path!r} is neither a .npz file nor a "
                         f"checkpoint directory (no 'latest', no {WEIGHTS_NAME})")
    logger.info(f"inference weights loaded from {path}")
    return params


def unwrap_logits(out):
    """An MoE model returns ``(logits, aux_loss)``; serving wants the logits
    (JAX ``inference/engine.py`` ``_unwrap_logits``)."""
    if isinstance(out, (tuple, list)):
        return out[0]
    return out


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator], do_sample: bool,
                  temperature: float, top_k: int, top_p: float) -> torch.Tensor:
    """Next-token selection on [B, V] logits (greedy, or filtered sampling
    drawn from ``generator``)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / max(float(temperature), 1e-6)
    neg_inf = torch.full((), float("-inf"), device=logits.device)
    if top_k > 0:
        k = min(int(top_k), logits.shape[-1])  # clamp to vocab
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # an empty nucleus keeps the argmax token; the clamp keeps rounding
        # from walking the index off the vocab axis
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_max(logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def replace_transformer_layer(model, config: DeepSpeedInferenceConfig, device: torch.device,
                              params: Optional[dict] = None):
    """Kernel injection: rebuild ``model`` (its own class) with the serving
    dtype and, with ``replace_with_kernel_inject`` and
    ``use_flash_prefill``, the CUDA flash attention backend. A model class
    whose attention takes what the flash kernels do not declares it in
    ``xla_attention_reason`` and keeps ``"xla"``, with the reason logged. Weights come from ``params`` (a
    state dict) or the model itself. The module is built on the meta device,
    with no storage and no random init, and then takes each tensor as it
    is (``load_state_dict(assign=True)``) where it already has the serving
    dtype and device, and a converted copy where not: a model already in
    the serving dtype is served from its own tensors, without a second
    copy."""
    mcfg = model.config
    name = type(model).__name__
    updates = {}
    # int8 means quantized weights served at bf16 (quantized after the build)
    dtype = torch.bfloat16 if config.dtype == torch.int8 else config.dtype
    if dtype is not None:
        updates.update(dtype=dtype, param_dtype=dtype)
    if config.replace_with_kernel_inject and config.use_flash_prefill:
        reason = getattr(type(model), "xla_attention_reason", None)
        if reason is not None:
            logger.info(f"inference injection: {name} keeps attention_backend 'xla' ({reason})")
        else:
            updates["attention_backend"] = "flash"
    module = type(model)(dataclasses.replace(mcfg, **updates), device="meta")
    module.device = device
    template = module.state_dict()
    state = params if params is not None else model.state_dict()
    module.load_state_dict({k: v.to(device=device, dtype=template[k].dtype) if k in template else v
                            for k, v in state.items()}, strict=True, assign=True)
    logger.info(f"inference injection: {name} config updates {sorted(updates)}")
    return module


class InferenceEngine:
    """Serving wrapper. ``engine(input_ids)`` -> logits;
    ``engine.generate(input_ids, ...)`` -> prompt plus generated token ids."""

    PREFILL_CHUNK = 16

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params: Optional[dict] = None, device: DeviceLike = None, seed: int = 0):
        self.config = config if config is not None else DeepSpeedInferenceConfig()
        self.device = resolve_device(device)
        if params is None and self.config.checkpoint is not None:
            params = _load_checkpoint_params(self.config.checkpoint, self.config.base_dir,
                                             model.config)
        self.module = replace_transformer_layer(model, self.config, self.device, params)
        self.mcfg = self.module.config
        self._wq_scales: Optional[Dict[str, torch.Tensor]] = None
        self._wq_codes: Dict[str, torch.Tensor] = {}
        if self.config.quantize_weights:
            self._quantize_weights()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the context and decode-cache length: LLaMA's max_position_embeddings
        # or GPT-2's n_positions (JAX _model_max_len)
        self._max_len = int(getattr(self.mcfg, "max_position_embeddings", None)
                            or self.mcfg.n_positions)

    # -- engine-wide int8 weights (JAX ``engine.py:163-174, 199-206``) ------
    @torch.no_grad()
    def _quantize_weights(self) -> None:
        """Replace each quantizable weight of the serving module by int8
        codes and fp32 group scales on the card. The module's own copy of
        such a weight becomes an empty tensor: the engine keeps no
        full-precision copy of it, and :meth:`_mparams` supplies the weight
        inside each call."""
        qcfg = self.config.quant
        codes, scales = WeightQuantization(mp_size=1).model_quantize(
            dict(self.module.state_dict()), quantize_bits=qcfg.bits,
            group_size=max(1, qcfg.group_size))
        self._wq_scales = scales
        self._wq_codes = {name: codes[name] for name in scales}
        for name, codes in self._wq_codes.items():
            scope, _, leaf = name.rpartition(".")
            self.module.get_submodule(scope)._parameters[leaf] = torch.nn.Parameter(
                torch.empty(0, dtype=self.mcfg.param_dtype, device=codes.device),
                requires_grad=False)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The served weights as the engine holds them: the module's state
        dict with each quantized weight's int8 codes in its place."""
        out = dict(self.module.state_dict())
        out.update(self._wq_codes)
        return out

    def _mparams(self) -> Dict[str, torch.Tensor]:
        """The dequantized weights of this call, in the serving dtype (empty
        without int8 weights)."""
        if self._wq_scales is None:
            return {}
        return dequantize_tree(self._wq_codes, self._wq_scales, self.mcfg.dtype)

    def _apply(self, ids: torch.Tensor, cache=None) -> torch.Tensor:
        """Logits of one full or cached call of the serving module."""
        if self._wq_scales is None:
            return unwrap_logits(self.module(ids, cache))
        return unwrap_logits(torch.func.functional_call(self.module, self._mparams(), (ids, cache),
                                                        strict=False))

    @torch.inference_mode()
    def forward(self, input_ids) -> torch.Tensor:
        """Full-sequence logits (no cache)."""
        if isinstance(input_ids, torch.Tensor):
            ids = input_ids.to(device=self.device, dtype=torch.int64)
        else:
            ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64, device=self.device)
        return self._apply(ids)

    __call__ = forward

    @staticmethod
    def _pow2_bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: Optional[int] = None, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, num_beams: int = 1,
                 length_penalty: float = 1.0, decoder_start_token_id: Optional[int] = None
                 ) -> torch.Tensor:
        """Generate up to ``max_new_tokens`` continuations per row. Returns a
        CPU int32 tensor [B, prompt + generated]. ``num_beams > 1`` runs beam
        search (greedy expansion, the best beam by ``scores / length **
        length_penalty``). A call that is refused raises before it draws
        from the engine's generator."""
        if num_beams > 1 and do_sample:
            raise ValueError("num_beams > 1 requires do_sample=False (beam-sample hybrid is not "
                             "supported)")
        if decoder_start_token_id is not None:
            raise NotImplementedError("encoder-decoder generate (greedy and beam) waits with the "
                                      "T5 family, a later slice of the PyTorch port (ROADMAP.md "
                                      "Queue A item 6)")
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu().numpy()
        ids_np = np.asarray(input_ids, np.int32)
        real_batch, prompt_len = ids_np.shape
        max_new = int(max_new_tokens if max_new_tokens is not None else self.config.max_new_tokens)
        if prompt_len + max_new > self._max_len:
            raise ValueError(f"prompt ({prompt_len}) + max_new_tokens ({max_new}) exceeds the model "
                             f"context/cache length {self._max_len}")
        if max_new > int(self.config.max_tokens or self._max_len):
            raise ValueError(f"max_new_tokens ({max_new}) exceeds the configured output budget "
                             f"max_tokens={self.config.max_tokens}")
        batch = self._pow2_bucket(real_batch)
        if batch != real_batch:
            ids_np = np.concatenate([ids_np, np.repeat(ids_np[:1], batch - real_batch, axis=0)])
        gen = generator if generator is not None else self.generator
        ids = torch.as_tensor(ids_np, dtype=torch.int64, device=self.device)
        cache = init_cache(self.module, batch)
        chunk = self.PREFILL_CHUNK
        pos = 0
        last_logits = None
        while pos + chunk <= prompt_len:
            last_logits = self._apply(ids[:, pos:pos + chunk], cache)[:, -1]
            pos += chunk
        while pos < prompt_len:
            last_logits = self._apply(ids[:, pos:pos + 1], cache)[:, -1]
            pos += 1
        if max_new <= 0:
            return torch.as_tensor(ids_np[:real_batch])
        eos = -1 if eos_token_id is None else int(eos_token_id)
        if num_beams > 1:
            gen_ids = self._beam_search(cache, last_logits, batch, num_beams, max_new, eos,
                                        float(length_penalty))
            return torch.cat([torch.as_tensor(ids_np), gen_ids], dim=1)[:real_batch]
        tok = sample_logits(last_logits, gen, do_sample, temperature, top_k, top_p)
        out = [tok]
        done = tok == eos
        for _ in range(1, max_new):
            if eos >= 0 and bool(done.all()):
                break
            logits = self._apply(tok[:, None], cache)[:, 0]
            nxt = sample_logits(logits, gen, do_sample, temperature, top_k, top_p)
            tok = torch.where(done, torch.full_like(nxt, max(eos, 0)), nxt)
            out.append(tok)
            done = done | (tok == eos)
        gen_ids = torch.stack(out, dim=1).to(torch.int32).cpu()
        return torch.cat([torch.as_tensor(ids_np), gen_ids], dim=1)[:real_batch]

    # -- beam search (JAX ``engine.py:285-383``) ---------------------------
    @staticmethod
    def _top_beams(scores: torch.Tensor, beams: int):
        """The ``beams`` best of each row of ``scores`` [B, N], highest
        first and, among equal scores, the lower index first (the order of
        ``jax.lax.top_k``; ``torch.topk`` promises none on CUDA)."""
        values, index = torch.sort(scores, dim=-1, descending=True, stable=True)
        return values[:, :beams], index[:, :beams]

    @staticmethod
    def _reindex_cache(cache: Dict[str, torch.Tensor], rows: torch.Tensor) -> None:
        """Gather the per-row KV leaves (by name: K, V and int8 scales) by
        ``rows`` into new contiguous tensors; the host counters stay."""
        for name in list(cache):
            if name.rsplit("/", 1)[-1] in BEAM_CACHE_LEAVES:
                cache[name] = cache[name].index_select(0, rows)

    def _beam_search(self, cache, last_logits, batch: int, beams: int, max_new: int, eos: int,
                     length_penalty: float) -> torch.Tensor:
        """Decoder-only beam search over the prefilled ``cache`` [batch,
        ...]: every live hypothesis is one row of a ``[batch * beams]``
        decode batch. A finished beam stays finished (its only continuation
        is ``eos`` at log-probability 0). Returns the best beam's tokens,
        a CPU int32 tensor [batch, steps]."""
        dev = last_logits.device
        lp0 = torch.log_softmax(last_logits.float(), dim=-1)  # [B, V]
        vocab = lp0.shape[-1]
        scores, tok = self._top_beams(lp0, beams)  # [B, beams]
        fill = torch.full((), max(eos, 0), dtype=tok.dtype, device=dev)
        seqs = fill.expand(batch, beams, max_new).clone()  # each live beam's tokens
        seqs[:, :, 0] = tok
        steps = 1
        done = tok == eos
        lens = torch.ones((batch, beams), dtype=torch.int32, device=dev)
        done_lp = torch.full((vocab,), float("-inf"), device=dev)
        done_lp[max(eos, 0)] = 0.0
        base = (torch.arange(batch, device=dev) * beams)[:, None]
        self._reindex_cache(cache, torch.arange(batch, device=dev).repeat_interleave(beams))
        for step in range(1, max_new):
            if bool(done.all()):
                break
            logits = self._apply(tok.reshape(batch * beams, 1), cache)[:, 0]
            lp = torch.log_softmax(logits.float(), dim=-1).reshape(batch, beams, vocab)
            lp = torch.where(done[:, :, None], done_lp, lp)
            total = scores[:, :, None] + lp
            scores, flat = self._top_beams(total.reshape(batch, beams * vocab), beams)
            beam_src = flat // vocab
            new_tok = flat % vocab
            prev_done = torch.gather(done, 1, beam_src)
            lens = torch.gather(lens, 1, beam_src) + (~prev_done).to(torch.int32)
            seqs = torch.gather(seqs, 1, beam_src[:, :, None].expand(-1, -1, max_new))
            seqs[:, :, step] = torch.where(prev_done, fill, new_tok)
            steps = step + 1
            done = prev_done | (new_tok == eos)
            tok = new_tok
            self._reindex_cache(cache, (base + beam_src).reshape(-1))
        norm = scores / lens.float() ** length_penalty
        best = torch.argmax(norm, dim=-1)
        return seqs[torch.arange(batch, device=dev), best, :steps].to(torch.int32).cpu()
