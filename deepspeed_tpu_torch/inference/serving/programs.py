"""Fixed-shape serving steps over a per-slot (ragged) decode cache
(counterpart of ``deepspeed_tpu/inference/serving/programs.py``).

Two steps serve every request mix: a chunked prefill and a one-token
decode, whose shapes never change while requests join and leave. Join and
leave are positional: the cache's index leaves are [slots] write-position
vectors the scheduler stamps from its host-side length mirror before every
tick, and a parked slot carries the sentinel position ``capacity`` so its KV
writes drop and its (finite, meaningless) logits are discarded on the host.

The cache is a dict of tensors the model updates in place (the JAX steps
returned a new cache); the index leaves live on the host.
"""

from typing import Callable, Dict

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import sample_logits
from deepspeed_tpu_torch.models.common import init_cache

#: cache leaves that hold write positions (scalar in ``generate``'s lockstep
#: cache; [slots] vectors in the serving cache)
INDEX_LEAVES = ("cache_index", "position_index")

#: KV pool leaves (``models/gpt2.py`` SelfAttention decode cache)
KV_LEAVES = ("cached_key", "cached_value")


def _leaf_name(key: str) -> str:
    return key.rsplit("/", 1)[-1]


def make_slot_cache(module, slots: int, kv_quant: bool = False) -> Dict[str, torch.Tensor]:
    """A per-slot serving cache: the model's decode cache with every index
    leaf widened from a scalar to a [slots] vector (which switches the
    model's decode branch to per-slot writes and per-slot lengths). Slots
    start parked. ``kv_quant=True`` turns the KV pools into int8 codes with
    a ``<leaf>_scale`` [slots, P, H, 1] companion each."""
    cache = init_cache(module, slots)
    parked = slot_capacity(cache)
    for name, leaf in cache.items():
        if _leaf_name(name) in INDEX_LEAVES:
            cache[name] = torch.full((slots,), parked, dtype=torch.int64, device=leaf.device)
    if kv_quant:
        cache = quantize_slot_cache(cache)
    return cache


def quantize_slot_cache(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """int8-KV view of a fresh slot cache: each KV pool becomes int8 codes
    and gains a per-(slot, position, head) scale leaf in the pool's dtype.
    Zero scales on unwritten rows dequantize to the zeros an fp cache holds."""
    out = {}
    for name, leaf in cache.items():
        if _leaf_name(name) in KV_LEAVES:
            out[name] = torch.zeros(leaf.shape, dtype=torch.int8, device=leaf.device)
            out[name + "_scale"] = torch.zeros(leaf.shape[:-1] + (1,), dtype=leaf.dtype,
                                               device=leaf.device)
        else:
            out[name] = leaf
    return out


def slot_capacity(cache: Dict[str, torch.Tensor]) -> int:
    """Token capacity per slot = the KV pool's position extent (also the
    parked-slot sentinel position)."""
    for name, leaf in cache.items():
        if _leaf_name(name) in KV_LEAVES:
            return int(leaf.shape[1])
    raise ValueError("cache has no cached_key leaves — not a decode cache")


def stamp_lengths(cache: Dict[str, torch.Tensor], write_pos: np.ndarray) -> Dict[str, torch.Tensor]:
    """Stamp the scheduler's per-slot write positions into every index leaf
    (in place; the KV leaves are untouched)."""
    pos = torch.as_tensor(np.asarray(write_pos, np.int64))
    for name, leaf in cache.items():
        if _leaf_name(name) in INDEX_LEAVES:
            leaf.copy_(pos)
    return cache


def make_apply_fn(module) -> Callable:
    """The one decode apply shared by the serving steps:
    ``apply_fn(cache, ids) -> logits [S, L, V]``, cache updated in place,
    with no autograd graph recorded."""

    @torch.inference_mode()
    def apply_fn(cache, ids):
        return module(ids, cache)

    return apply_fn


def build_prefill_step(apply_fn, do_sample: bool, temperature: float,
                       top_k: int, top_p: float) -> Callable:
    """One chunked-prefill tick: consume ``ids [S, C]`` at each slot's own
    write position. ``last_idx [S]`` names each slot's final real token in
    the chunk (a short final chunk is right-padded; pad positions are
    re-written later and never attended by real queries); the token
    sampled there is the request's first new token."""

    def last_logits(logits, last_idx):
        return logits[torch.arange(logits.shape[0], device=logits.device), last_idx]

    if do_sample:
        def prefill(cache, ids, last_idx, generator):
            logits = apply_fn(cache, ids)
            return sample_logits(last_logits(logits, last_idx), generator, True,
                                 temperature, top_k, top_p)
    else:
        def prefill(cache, ids, last_idx):
            return torch.argmax(last_logits(apply_fn(cache, ids), last_idx), dim=-1)

    return prefill


def build_decode_step(apply_fn, do_sample: bool, temperature: float,
                      top_k: int, top_p: float) -> Callable:
    """One decode tick: feed each slot's token, pick the next."""
    if do_sample:
        def decode(cache, tokens, generator):
            logits = apply_fn(cache, tokens[:, None])
            return sample_logits(logits[:, -1], generator, True, temperature, top_k, top_p)
    else:
        def decode(cache, tokens):
            return torch.argmax(apply_fn(cache, tokens[:, None])[:, -1], dim=-1)

    return decode
