"""DeepSpeedTransformerLayer: the training encoder layer of upstream's
fused transformer kernels (counterpart of
``deepspeed_tpu/ops/transformer/transformer.py``).

One module runs the whole layer: the fused QKV projection, attention on
the config's backend (``"flash"``: K1 forward and K4 backward,
non-causal), the output projection, the residuals and norms, and the exact
GELU MLP; pre-LN with ``pre_layer_norm`` (the default), else post-LN.
``adjust_init_range`` draws the two output projections at
``initializer_range / sqrt(2 num_hidden_layers)``. The three memory
switches (``normalize_invertible``, ``gelu_checkpoint``,
``attn_dropout_checkpoint``) become one ``torch.utils.checkpoint`` region
around the layer (``models/common.maybe_remat``); ``local_rank``,
``seed``, ``fp16``, ``stochastic_mode`` and ``test_gemm``-style plumbing are
taken and change nothing, as in JAX.

The weights have JAX's names and layouts under ``layer``:
``attn_qkv.kernel [E, 3, H, D]`` (bias ``[3, H, D]``), ``attn_out.kernel
[H, D, E]``, ``inter [E, I]``, ``output [I, E]``, ``attn_norm`` and
``norm`` (``scale``, ``bias``). An ``attention_mask`` ``[B, L]`` (0/1) or
broadcastable to ``[B, H, Lq, Lk]`` is a boolean key mask on the ``"xla"``
backend; the flash backend takes none and raises on one.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.device import DeviceLike, resolve_device
from deepspeed_tpu_torch.models.common import (Dense, LayerNorm, dense_init, dropout, maybe_remat,
                                               normalize_padding_mask)
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """Upstream's knob names (JAX ``transformer.py:32-86``)."""

    batch_size: int = -1
    hidden_size: int = -1
    intermediate_size: int = -1
    heads: int = -1
    attn_dropout_ratio: float = -1
    hidden_dropout_ratio: float = -1
    num_hidden_layers: int = -1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    local_rank: int = -1
    seed: int = -1
    fp16: bool = False
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    return_tuple: bool = False
    training: bool = True
    attention_backend: str = "xla"
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    layer_id: int = -1

    def __post_init__(self):
        if self.intermediate_size < 0 and self.hidden_size > 0:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def head_dim(self):
        return self.hidden_size // self.heads

    @property
    def remat(self) -> bool:
        # upstream's three recompute switches trade activation memory for
        # FLOPs; one checkpoint region does that for the whole layer
        return self.normalize_invertible or self.gelu_checkpoint or self.attn_dropout_checkpoint


class _LayerCore(nn.Module):

    def __init__(self, cfg: DeepSpeedTransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.hidden_size, cfg.heads, cfg.head_dim
        self.attn_qkv = Dense(cfg, (e, 3, h, d), 1, device, bias=True)
        self.attn_out = Dense(cfg, (h, d, e), 2, device, bias=True)
        self.inter = Dense(cfg, (e, cfg.intermediate_size), 1, device, bias=True)
        self.output = Dense(cfg, (cfg.intermediate_size, e), 1, device, bias=True)
        self.attn_norm = LayerNorm(cfg, cfg.hidden_size, "layer_norm_eps", device)
        self.norm = LayerNorm(cfg, cfg.hidden_size, "layer_norm_eps", device)

    def forward(self, x, mask, dropout_seed: Optional[int] = None):
        cfg = self.cfg
        gen = None
        if dropout_seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(dropout_seed)
        hidden_rate = max(cfg.hidden_dropout_ratio, 0.0)

        def attn_block(h):
            qkv = self.attn_qkv(h)
            q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
            rate = max(cfg.attn_dropout_ratio, 0.0) if gen is not None else 0.0
            drop = dict(dropout_rate=rate, generator=gen) if rate > 0.0 else {}
            a = dot_product_attention(q, k, v, backend=cfg.attention_backend, causal=False,
                                      mask=mask, **drop)
            return dropout(self.attn_out(a), hidden_rate, gen)

        def mlp_block(h):
            return dropout(self.output(F.gelu(self.inter(h))), hidden_rate, gen)

        if cfg.pre_layer_norm:
            x = x + attn_block(self.attn_norm(x))
            return x + mlp_block(self.norm(x))
        x = self.attn_norm(x + attn_block(x))
        return self.norm(x + mlp_block(x))


class DeepSpeedTransformerLayer(nn.Module):
    """``layer(hidden_states, attention_mask)`` -> hidden states, or a
    1-tuple under ``config.return_tuple``. ``deterministic=False`` with a
    ``generator`` applies the config's dropout ratios."""

    def __init__(self, config: DeepSpeedTransformerConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = self.device = resolve_device(device)
        self.layer = _LayerCore(cfg, dev)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """JAX's init: normal ``initializer_range`` for the QKV and MLP-in
        kernels, the same over ``sqrt(2 num_hidden_layers)`` for the two
        output projections under ``adjust_init_range``, zero biases, unit
        norm scales; drawn from ``generator`` (seeded 0 when None)."""
        cfg = self.config
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out_scale = cfg.initializer_range
        if cfg.adjust_init_range and cfg.num_hidden_layers > 0:
            out_scale = cfg.initializer_range / math.sqrt(2.0 * cfg.num_hidden_layers)
        core = self.layer
        dense_init(cfg.initializer_range)(core.attn_qkv.kernel, generator)
        dense_init(out_scale)(core.attn_out.kernel, generator)
        dense_init(cfg.initializer_range)(core.inter.kernel, generator)
        dense_init(out_scale)(core.output.kernel, generator)

    def forward(self, hidden_states: torch.Tensor, attention_mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        cfg = self.config
        mask = normalize_padding_mask(attention_mask)
        seed = None
        if not deterministic and max(cfg.attn_dropout_ratio, cfg.hidden_dropout_ratio) > 0.0:
            if generator is None:
                raise ValueError("training with dropout needs a generator")
            seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
        out = maybe_remat(self.layer, cfg, 0)(hidden_states.to(self.device), mask, seed)
        return (out,) if cfg.return_tuple else out


def param_shapes(cfg: DeepSpeedTransformerConfig) -> dict:
    """State-dict key -> (shape, dtype) of :class:`DeepSpeedTransformerLayer`."""
    e, h, d, i, pd = cfg.hidden_size, cfg.heads, cfg.head_dim, cfg.intermediate_size, cfg.param_dtype
    out = {}
    for name, kshape, nc in (("attn_qkv", (e, 3, h, d), 1), ("attn_out", (h, d, e), 2),
                             ("inter", (e, i), 1), ("output", (i, e), 1)):
        out[f"layer.{name}.kernel"] = (kshape, pd)
        out[f"layer.{name}.bias"] = (kshape[nc:], pd)
    for name in ("attn_norm", "norm"):
        out[f"layer.{name}.scale"] = ((e,), pd)
        out[f"layer.{name}.bias"] = ((e,), pd)
    return out
