"""Shared model helpers (the serving subset of
``deepspeed_tpu/models/common.py``)."""

from typing import Dict

import torch


def embed_lookup(wte: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Token-embedding gather."""
    return torch.nn.functional.embedding(ids, wte)


def config_from(table: dict, cls, name: str, **overrides):
    """Look up a named config dict and build ``cls`` with overrides."""
    base = dict(table[name])
    base.update(overrides)
    return cls(**base)


def init_cache(model, batch_size: int) -> Dict[str, torch.Tensor]:
    """A zeroed decode cache for a model that declares ``cache_shapes``.

    The cache is a flat dict keyed by the JAX package's cache paths
    (``"h_0/attn/cached_key"``, ``"position_index"``...). The model updates
    it in place on every decode call, where the JAX model returned a new
    cache. The index leaves (``cache_index``, ``position_index``) live on
    the host: the caller's position mirror is the authority, and a host
    index lets a write drop out-of-range rows without a device round trip.
    """
    cache = {}
    for name, (shape, dtype, device) in model.cache_shapes(batch_size).items():
        cache[name] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def flatten_tree(tree: dict, sep: str, prefix: str = "") -> Dict[str, object]:
    """Nested dicts -> one flat dict keyed by the joined path."""
    out = {}
    for name, leaf in tree.items():
        key = f"{prefix}{sep}{name}" if prefix else str(name)
        if isinstance(leaf, dict):
            out.update(flatten_tree(leaf, sep, key))
        else:
            out[key] = leaf
    return out


def nest_tree(flat: Dict[str, object], sep: str) -> dict:
    """Inverse of :func:`flatten_tree`."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *scopes, name = key.split(sep)
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[name] = leaf
    return tree
