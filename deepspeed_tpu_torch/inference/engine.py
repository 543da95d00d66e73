"""InferenceEngine: full-sequence forward and lockstep KV-cache generation
(counterpart of ``deepspeed_tpu/inference/engine.py``).

Kernel injection rebuilds the model with the serving dtype and, with
``use_flash_prefill``, the ``"flash"`` attention backend: K1 for
``forward`` and K3 for every cached decode step. ``generate`` runs a
chunked prefill (``PREFILL_CHUNK`` tokens per call plus single-token
remainders) and then a Python token loop, where the JAX engine ran one
``lax.while_loop`` on the device; capturing the loop in a CUDA graph is
later work. Beam search, tensor parallelism and encoder-decoder models are
later slices.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models.common import init_cache


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
    """Kernel injection: rebuild ``model`` (its own class: GPT-2 or a LLaMA
    family model) with the serving dtype (weights cast to it) and, with
    ``replace_with_kernel_inject`` and ``use_flash_prefill``, the CUDA flash
    attention backend. Weights come from ``params`` (a state dict) or the
    model itself."""
    mcfg = model.config
    updates = {}
    if config.dtype is not None:
        updates.update(dtype=config.dtype, param_dtype=config.dtype)
    if config.replace_with_kernel_inject and config.use_flash_prefill:
        updates["attention_backend"] = "flash"
    module = type(model)(dataclasses.replace(mcfg, **updates), device=device)
    state = params if params is not None else model.state_dict()
    module.load_state_dict(state, strict=True)
    return module


class InferenceEngine:
    """Serving wrapper. ``engine(input_ids)`` -> logits;
    ``engine.generate(input_ids, ...)`` -> prompt plus generated token ids."""

    PREFILL_CHUNK = 16

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params: Optional[dict] = None, device: DeviceLike = None, seed: int = 0):
        self.config = config if config is not None else DeepSpeedInferenceConfig()
        self.device = resolve_device(device)
        if getattr(model.config, "moe_num_experts", 0) > 0:
            raise NotImplementedError("serving an MoE model belongs to the MoE-serving slice of "
                                      "the PyTorch port")
        self.module = replace_transformer_layer(model, self.config, self.device, params)
        self.mcfg = self.module.config
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the context and decode-cache length: LLaMA's max_position_embeddings
        # or GPT-2's n_positions (JAX _model_max_len)
        self._max_len = int(getattr(self.mcfg, "max_position_embeddings", None)
                            or self.mcfg.n_positions)

    @torch.inference_mode()
    def forward(self, input_ids) -> torch.Tensor:
        """Full-sequence logits (no cache)."""
        if isinstance(input_ids, torch.Tensor):
            ids = input_ids.to(device=self.device, dtype=torch.int64)
        else:
            ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64, device=self.device)
        return self.module(ids)

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
                 generator: Optional[torch.Generator] = None, num_beams: int = 1) -> torch.Tensor:
        """Generate up to ``max_new_tokens`` continuations per row. Returns a
        CPU int32 tensor [B, prompt + generated]."""
        if num_beams != 1:
            raise NotImplementedError("beam search is a later slice of the PyTorch port")
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
            last_logits = self.module(ids[:, pos:pos + chunk], cache)[:, -1]
            pos += chunk
        while pos < prompt_len:
            last_logits = self.module(ids[:, pos:pos + 1], cache)[:, -1]
            pos += 1
        if max_new <= 0:
            return torch.as_tensor(ids_np[:real_batch])
        eos = -1 if eos_token_id is None else int(eos_token_id)
        tok = sample_logits(last_logits, gen, do_sample, temperature, top_k, top_p)
        out = [tok]
        done = tok == eos
        for _ in range(1, max_new):
            if eos >= 0 and bool(done.all()):
                break
            logits = self.module(tok[:, None], cache)[:, 0]
            nxt = sample_logits(logits, gen, do_sample, temperature, top_k, top_p)
            tok = torch.where(done, torch.full_like(nxt, max(eos, 0)), nxt)
            out.append(tok)
            done = done | (tok == eos)
        gen_ids = torch.stack(out, dim=1).to(torch.int32).cpu()
        return torch.cat([torch.as_tensor(ids_np), gen_ids], dim=1)[:real_batch]
