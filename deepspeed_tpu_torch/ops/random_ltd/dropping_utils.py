"""Random-LTD functional primitives (counterpart of
``deepspeed_tpu/ops/random_ltd/dropping_utils.py``): ``gpt_sample_tokens``,
``bert_sample_tokens``, ``token_sort_``, ``token_gather`` and
``token_scatter_``, with JAX's shape contracts:

* the sample functions give ``sampled_indices [layers, batch, reserved]``,
  sorted ascending and distinct in each row, and the truncated attention
  mask;
* ``token_gather`` and ``token_scatter_`` are differentiable through
  autograd (``gather``'s backward is the zero-filled scatter, and
  ``scatter``'s is the gather), and ``token_scatter_`` returns a new tensor,
  as JAX's ``.at[].set`` does, so that it never writes into a tensor
  autograd saved.

The draws come from a ``torch.Generator`` (the default one when None), not
from JAX's threefry keys: the same call gives other indices in the two
packages. Tests inject JAX's indices.
"""

from typing import Optional, Tuple

import torch


def token_sort_(indices: torch.Tensor, seq_length: int = 0) -> torch.Tensor:
    """Sort each row of ``indices`` ascending, in place, and return it.
    ``seq_length`` is taken for the reference's signature."""
    del seq_length
    indices.copy_(torch.sort(indices, dim=-1).values)
    return indices


def _sample(generator: Optional[torch.Generator], layers: int, batch: int, seq: int,
            reserved: int, device) -> torch.Tensor:
    """[layers, batch, reserved] distinct sorted positions a row: uniform
    sampling without replacement (the first ``reserved`` of a random
    permutation)."""
    if reserved > seq:
        raise ValueError(f"reserved_length {reserved} > seq_length {seq}")
    if generator is not None:
        device = generator.device
    keys = torch.rand((layers * batch, seq), generator=generator, device=device)
    idx = keys.argsort(dim=-1)[:, :reserved]
    return torch.sort(idx, dim=-1).values.reshape(layers, batch, reserved)


def gpt_sample_tokens(reserved_length: int, seq_length: int, batch_size: int, layers: int = 1,
                      generator: Optional[torch.Generator] = None,
                      attn_mask: Optional[torch.Tensor] = None, device=None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Causal sampling: the indices and the causal mask cut to the reserved
    square (``[B, 1, r, r]``)."""
    sampled = _sample(generator, layers, batch_size, seq_length, reserved_length, device)
    new_mask = None
    if attn_mask is not None:
        new_mask = attn_mask[..., :reserved_length, :reserved_length]
    return sampled, new_mask


def bert_sample_tokens(reserved_length: int, seq_length: int, batch_size: int, layers: int = 1,
                       generator: Optional[torch.Generator] = None,
                       attn_mask: Optional[torch.Tensor] = None, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional sampling: each layer's mask gathered at its sampled
    rows and columns (``[layers, B, 1, r, r]`` from a ``[B, 1, L, L]``
    mask)."""
    if attn_mask is None:
        raise ValueError("bert_sample_tokens requires attn_mask")
    sampled = _sample(generator, layers, batch_size, seq_length, reserved_length,
                      attn_mask.device if device is None else device)
    idx = sampled.to(attn_mask.device)
    masks = []
    for layer in range(layers):
        rows = []
        for b in range(batch_size):
            m = attn_mask[b]
            rows.append(m[..., idx[layer, b], :][..., :, idx[layer, b]])
        masks.append(torch.stack(rows))
    return sampled, torch.stack(masks)


def _token_index(sorted_indices: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``[B, r]`` indices (the trailing two dims of ``sorted_indices``)
    expanded over ``like``'s trailing feature dims, for ``gather``/``scatter``
    along dim 1."""
    idx = sorted_indices.reshape(sorted_indices.shape[-2:]).to(device=like.device,
                                                               dtype=torch.int64)
    idx = idx.reshape(idx.shape + (1,) * (like.dim() - 2))
    return idx.expand(idx.shape[:2] + like.shape[2:])


def token_gather(activations: torch.Tensor, sorted_indices: torch.Tensor,
                 batch_first: bool = True) -> torch.Tensor:
    """Keep the sampled tokens: ``[B, L, ...]`` -> ``[B, r, ...]`` (``[L,
    B, ...]`` -> ``[r, B, ...]`` with ``batch_first=False``)."""
    if not batch_first:
        activations = activations.transpose(0, 1)
    out = torch.gather(activations, 1, _token_index(sorted_indices, activations))
    return out if batch_first else out.transpose(0, 1)


def token_scatter_(all_activations: torch.Tensor, layer_activations: torch.Tensor,
                   sorted_indices: torch.Tensor, batch_first: bool = True) -> torch.Tensor:
    """The full sequence with the processed reserved tokens written back at
    their positions: a new tensor (JAX's functional ``.at[].set``), the
    inputs untouched."""
    if not batch_first:
        all_activations = all_activations.transpose(0, 1)
        layer_activations = layer_activations.transpose(0, 1)
    out = torch.scatter(all_activations, 1, _token_index(sorted_indices, all_activations),
                        layer_activations.to(all_activations.dtype))
    return out if batch_first else out.transpose(0, 1)
