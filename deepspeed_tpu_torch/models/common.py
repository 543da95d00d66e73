"""Shared model helpers (the serving and training subset of
``deepspeed_tpu/models/common.py``)."""

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import checkpoint_with_policy
from deepspeed_tpu_torch.runtime.zero.param_offload import stream_block


def embed_lookup(wte: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Token-embedding gather. Its backward is ``F.embedding``'s
    scatter-add, which gives the fp32 gradient the JAX package computes as
    a one-hot product (a TPU workaround for its scatter, so the port has no
    ``embed_onehot_grad`` knob)."""
    return F.embedding(ids, wte)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """RMS norm (JAX ``models/common.py:150``): the mean square in fp32,
    times the weight in fp32, rounded once to ``out_dtype``."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(out_dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm``: statistics in fp32 with the fast variance
    E[x^2] - E[x]^2 (clipped at 0), output in ``dtype``. Scale and bias are
    rounded to ``dtype`` first, as the JAX engine rounds every parameter."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * scale.to(dtype).float()
    return ((xf - mean) * mul + bias.to(dtype).float()).to(dtype)


class LayerNorm(torch.nn.Module):
    """flax ``nn.LayerNorm`` (:func:`layer_norm`) over ``size`` features.
    Its epsilon is the config field named ``eps_field`` and its output
    ``cfg.dtype``, both read from ``self.cfg`` at each call: the engine
    re-points ``cfg`` when it updates the model's config."""

    def __init__(self, cfg, size: int, eps_field: str, device):
        super().__init__()
        self.cfg = cfg
        self.eps_field = eps_field
        self.scale = torch.nn.Parameter(torch.ones(size, dtype=cfg.param_dtype, device=device))
        self.bias = torch.nn.Parameter(torch.zeros(size, dtype=cfg.param_dtype, device=device))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, getattr(self.cfg, self.eps_field), self.cfg.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element with probability
    ``1 - rate`` (drawn from ``generator``) and scale it by ``1 / (1 - rate)``;
    the identity without a generator (deterministic) or at rate 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def pld_gate(branch: torch.Tensor, keep: Optional[float], mask: Optional[torch.Tensor],
             which: int) -> torch.Tensor:
    """JAX ``pld_gate`` (``models/common.py:135``) with the draw made by the
    caller: ``branch / keep`` where ``mask[which]`` keeps the sublayer, 0
    where it drops it; the branch itself without a draw."""
    if mask is None:
        return branch
    return torch.where(mask[which], branch / keep, torch.zeros((), dtype=branch.dtype,
                                                                device=branch.device))


def pld_draws(n_layer: int, theta: float, generator: torch.Generator, device):
    """Progressive layer drop's per-block keep probabilities ``1 - (i + 1) /
    n_layer * (1 - theta)`` (JAX's depth rule) and one keep flag per
    sublayer, bool ``[n_layer, 2]`` (attention, then the MLP), drawn from
    ``generator``."""
    keeps = [1.0 - (i + 1) / n_layer * (1.0 - float(theta)) for i in range(n_layer)]
    draws = torch.rand((n_layer, 2), generator=generator, device=generator.device)
    return keeps, (draws < torch.tensor(keeps, device=draws.device)[:, None]).to(device)


class Dense(torch.nn.Module):
    """flax ``DenseGeneral`` over the trailing ``n_contract`` dims of the
    input: ``kernel`` of shape ``in_dims + out_dims``, an optional ``bias``
    of ``out_dims``, computed in ``cfg.dtype``."""

    def __init__(self, cfg, kshape, n_contract: int, device, bias: bool = False):
        super().__init__()
        self.cfg = cfg
        self.n_contract = n_contract
        self.kernel = torch.nn.Parameter(torch.zeros(kshape, dtype=cfg.param_dtype, device=device))
        self.bias = (torch.nn.Parameter(torch.zeros(kshape[n_contract:], dtype=cfg.param_dtype,
                                                    device=device)) if bias else None)

    def forward(self, x):
        dt = self.cfg.dtype
        nc = self.n_contract
        lead = x.shape[:x.dim() - nc]
        k = math.prod(self.kernel.shape[:nc])
        out = x.to(dt).reshape(*lead, k) @ self.kernel.to(dt).reshape(k, -1)
        out = out.reshape(*lead, *self.kernel.shape[nc:])
        return out if self.bias is None else out + self.bias.to(dt)


def normalize_padding_mask(attention_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A ``[B, L]`` 0/1 padding mask as a ``[B, 1, 1, L]`` boolean; a mask
    of another rank as a boolean of its own shape (JAX
    ``normalize_padding_mask``)."""
    if attention_mask is None:
        return None
    if attention_mask.dim() == 2:
        return attention_mask[:, None, None, :].bool()
    return attention_mask.bool()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean token cross-entropy with label masking: the log-sum-exp in fp32,
    the label logit read in the logits' dtype (JAX ``gpt2.py:636-651``, the
    loss of every causal-LM family)."""
    labels = labels.to(logits.device).long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits.float(), dim=-1)
    label_logit = logits.gather(-1, safe[..., None])[..., 0].float()
    nll = (logz - label_logit) * valid
    return nll.sum() / valid.sum().clamp_min(1)


def dense_init(scale: float = 0.02) -> Callable[[torch.Tensor, Optional[torch.Generator]], None]:
    """In-place normal(0, ``scale``) initializer, drawn from ``generator``."""

    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            t.normal_(0.0, scale, generator=generator)

    return init


def maybe_remat(block: Callable, cfg, layer_idx: int, enabled: Optional[bool] = None) -> Callable:
    """Activation checkpointing of one block: ``torch.utils.checkpoint``
    (non-reentrant) around ``block`` when remat is on and ``layer_idx`` hits
    the ``remat_every`` stride, else ``block`` itself, under the config's
    ``remat_policy`` (``runtime/activation_checkpointing``: which products
    the block keeps; None recomputes everything). Runs the block plainly
    when no graph is recorded (inference).

    Every block first passes through ``runtime/zero/param_offload.stream_block``:
    the identity unless an ``offload_param`` engine's forward is streaming,
    where the block's parameters are copied to the card inside the
    checkpoint region, so the recompute streams them again (JAX's
    ``stream_block_params``)."""
    block = stream_block(block)
    enabled = getattr(cfg, "remat", False) if enabled is None else enabled
    if not enabled or layer_idx % max(getattr(cfg, "remat_every", 1), 1) != 0:
        return block

    policy = getattr(cfg, "remat_policy", None)

    def run(*args):
        if not torch.is_grad_enabled():
            return block(*args)
        return checkpoint_with_policy(block, *args, policy=policy)

    return run


class _FusedLMHeadLoss(torch.autograd.Function):
    """Chunked LM head + mean cross-entropy that never builds [B, T, V]:
    the forward keeps one chunk's logits at a time and only sums the NLL;
    the backward recomputes each chunk's logits and feeds ``(softmax -
    onehot) * valid * g / denom``, cast to x's dtype, into the two products.
    Port of ``_fused_lm_head_loss_fn`` (``models/common.py:292-399``), whose
    chunk loop was a ``lax.scan``. The head is the tied ``[V, E]`` table
    (``vocab_major``, GPT-2) or an untied ``[E, V]`` kernel (LLaMA); each
    layout contracts its own axis, with no transposed copy. The backward is
    plain differentiable PyTorch (out of place when it builds a graph), so a second
    derivative (an HVP) is the derivative of this backward, as JAX's
    ``jvp`` of its ``custom_vjp``'s backward is."""

    @staticmethod
    def _padded(x, labels, chunk, ignore_index):
        e = x.shape[-1]
        x_f, lab_f = x.reshape(-1, e), labels.reshape(-1)
        pad = (-x_f.shape[0]) % chunk
        if pad:
            x_f = torch.cat([x_f, x_f.new_zeros((pad, e))])
            lab_f = torch.cat([lab_f, lab_f.new_full((pad,), ignore_index)])
        return x_f, lab_f

    @staticmethod
    def _logits(x_c, w, vocab_major):
        return x_c @ (w.t() if vocab_major else w)  # [C, V] in x's dtype

    @staticmethod
    def forward(ctx, x, w, labels, chunk, ignore_index, vocab_major):
        x_f, lab_f = _FusedLMHeadLoss._padded(x, labels, chunk, ignore_index)
        denom = (lab_f != ignore_index).sum().clamp_min(1).float()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, x_f.shape[0], chunk):
            lab_c = lab_f[lo:lo + chunk]
            logits = _FusedLMHeadLoss._logits(x_f[lo:lo + chunk], w, vocab_major)
            valid = lab_c != ignore_index
            safe = torch.where(valid, lab_c, torch.zeros_like(lab_c))
            logz = torch.logsumexp(logits.float(), dim=-1)
            ll = logits.gather(-1, safe[:, None])[:, 0].float()
            total = total + ((logz - ll) * valid).sum()
        ctx.save_for_backward(x, w, labels, denom)
        ctx.args = (chunk, ignore_index, vocab_major)
        return total / denom

    @staticmethod
    def backward(ctx, g):
        x, w, labels, denom = ctx.saved_tensors
        chunk, ignore_index, vocab_major = ctx.args
        x_f, lab_f = _FusedLMHeadLoss._padded(x, labels, chunk, ignore_index)
        scale = g / denom
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx_chunks = []
        # in place, unless the backward builds a graph (create_graph=True)
        graph = torch.is_grad_enabled()
        for lo in range(0, x_f.shape[0], chunk):
            x_c, lab_c = x_f[lo:lo + chunk], lab_f[lo:lo + chunk]
            logits = _FusedLMHeadLoss._logits(x_c, w, vocab_major)
            valid = lab_c != ignore_index
            safe = torch.where(valid, lab_c, torch.zeros_like(lab_c))
            coeff32 = torch.softmax(logits.float(), dim=-1)
            hot = torch.full_like(coeff32[:, :1], -1.0)
            if graph:
                coeff32 = coeff32.scatter_add(-1, safe[:, None], hot)
            else:
                coeff32.scatter_add_(-1, safe[:, None], hot)
            coeff32 = coeff32 * (valid * scale)[:, None]
            coeff = coeff32.to(x.dtype)
            # dx: fp32 accumulation rounded once to x's dtype; dw: fp32 sums
            # of the exact products of the x-dtype operands
            if vocab_major:
                dx_chunks.append(coeff @ w)
                prod = coeff.t().float() @ x_c.float()
            else:
                dx_chunks.append(coeff @ w.t())
                prod = x_c.t().float() @ coeff.float()
            dw = dw + prod if graph else dw.add_(prod)
        dx = torch.cat(dx_chunks)[:x.shape[0] * x.shape[1]].reshape(x.shape)
        return dx, dw.to(w.dtype), None, None, None, None


def fused_lm_head_loss(x: torch.Tensor, embedding: torch.Tensor, labels: torch.Tensor, *,
                       chunk: int = 1024, ignore_index: int = -100,
                       vocab_major: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy straight from hidden states, chunk by
    chunk (``x`` [B, T, E] already shifted: token t predicts ``labels[:,
    t]``; ``embedding`` the LM head in the compute dtype: the tied ``[V, E]``
    table with ``vocab_major=True`` (GPT-2), or the untied ``[E, V]`` Dense
    kernel with ``vocab_major=False`` (LLaMA), as JAX's
    ``fused_lm_head_loss`` takes them). Logits stay in x's dtype, the
    log-sum-exp runs in fp32, dW is summed in fp32 and rounded once to the
    head's dtype; tokens are padded to a multiple of ``chunk`` with
    ``ignore_index`` labels."""
    return _FusedLMHeadLoss.apply(x, embedding, labels.long(), int(chunk), int(ignore_index),
                                  bool(vocab_major))


def fused_head_loss_output(x: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor, cfg,
                           aux_total: Optional[torch.Tensor] = None,
                           deterministic: bool = True, vocab_major: bool = True) -> torch.Tensor:
    """The fused head as a causal LM uses it: the next-token shift
    (``x[:, :-1]`` predicts ``labels[:, 1:]``), then
    :func:`fused_lm_head_loss` with ``cfg.fused_head_loss_chunk`` on the
    head's layout (``vocab_major``). An MoE model's ``aux_total *
    moe_aux_loss_coef`` is added in training only (eval reports the pure
    cross-entropy, as the unfused eval does)."""
    loss = fused_lm_head_loss(x[:, :-1], weight, labels[:, 1:], chunk=cfg.fused_head_loss_chunk,
                              vocab_major=vocab_major)
    if aux_total is not None and not deterministic and cfg.moe_num_experts > 0:
        loss = loss + aux_total * cfg.moe_aux_loss_coef
    return loss


class StackedDense(torch.nn.Module):
    """``num_experts`` dense projections stacked: ``kernel`` [E, in, out]
    and, with ``bias``, ``bias`` [E, out] (the JAX ``nn.vmap`` layout of the
    MoE experts), run as one batched product ``[E, T, in] -> [E, T, out]``
    in ``cfg.dtype``."""

    def __init__(self, cfg, num_experts, in_features, features, device, bias: bool = True):
        super().__init__()
        self.cfg = cfg
        self.kernel = torch.nn.Parameter(torch.zeros((num_experts, in_features, features),
                                                     dtype=cfg.param_dtype, device=device))
        self.bias = (torch.nn.Parameter(torch.zeros((num_experts, features), dtype=cfg.param_dtype,
                                                    device=device)) if bias else None)

    def forward(self, x):
        dt = self.cfg.dtype
        out = torch.bmm(x.to(dt), self.kernel.to(dt))
        return out if self.bias is None else out + self.bias.to(dt)[:, None, :]


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


def decode_cache_shapes(scopes, batch_size: int, length: int, heads: int, head_dim: int, dtype,
                        device, position_index: bool = False):
    """The lockstep decode cache of a decoder whose attention layers sit at
    ``scopes`` (the JAX cache collection's paths, e.g. ``"h_0/attn"``): per
    layer a ``[batch, length, heads, head_dim]`` key and value pool and a
    host write index, and with ``position_index`` the model's own host
    index of its learned positions. name -> (shape, dtype, device)."""
    pool = ((batch_size, length, heads, head_dim), dtype, device)
    host_index = ((), torch.int64, torch.device("cpu"))
    shapes = {}
    for scope in scopes:
        shapes[f"{scope}/cache_index"] = host_index
        shapes[f"{scope}/cached_key"] = pool
        shapes[f"{scope}/cached_value"] = pool
    if position_index:
        shapes["position_index"] = host_index
    return shapes


def cache_write(cache: Dict[str, torch.Tensor], prefix: str, k: torch.Tensor, v: torch.Tensor):
    """Write ``k`` and ``v`` [B, L, H, D] into the layer's pools at its host
    index and advance the index in place (the JAX models'
    ``dynamic_update_slice`` of the cache collection). Returns ``(pool_k,
    pool_v, decode_lengths)``: the whole pools and the live length of every
    row, for the attention backend's cache decode."""
    pool_k, pool_v = cache[prefix + "cached_key"], cache[prefix + "cached_value"]
    idx = cache[prefix + "cache_index"]
    start, l = int(idx), k.shape[1]
    if start + l > pool_k.shape[1]:
        raise ValueError(f"decode write [{start}, {start + l}) exceeds the cache capacity "
                         f"{pool_k.shape[1]}")
    pool_k[:, start:start + l] = k
    pool_v[:, start:start + l] = v
    idx += l  # in place: the cache dict is the caller's
    return pool_k, pool_v, torch.full((k.shape[0],), start + l, dtype=torch.int32, device=k.device)


def cache_positions(cache: Optional[Dict[str, torch.Tensor]], prefix: str, l: int,
                    device) -> torch.Tensor:
    """Positions ``[1, l]`` of a call's tokens: 0.. for a full forward, the
    layer's cache index onward for a cached call (read before
    :func:`cache_write` advances it)."""
    start = 0 if cache is None else int(cache[prefix + "cache_index"])
    return torch.arange(start, start + l, device=device)[None]


def learned_positions(wpe: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]], l: int,
                      offset: int = 0) -> torch.Tensor:
    """Rows ``offset + p`` of a learned position table for a call of ``l``
    tokens: p from 0, or from the cache's host ``position_index``, which
    advances in place (JAX ``pos_idx`` of GPT-Neo and OPT)."""
    start = 0
    if cache is not None:
        pidx = cache["position_index"]
        start = int(pidx)
        pidx += l
    return wpe[offset + start:offset + start + l]


def tied_logits(x: torch.Tensor, table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The tied LM head: ``einsum("ble,ve->blv")`` of ``x`` with the ``[V, E]``
    embedding table in the compute dtype (JAX's ``preferred_element_type``:
    the logits stay in that dtype)."""
    return x.to(dtype) @ table.to(dtype).t()


#: what the decoder families' training slice brings, refused until then
LATER_SLICE = "the decoder families' training slice of the PyTorch port (ROADMAP.md Queue A item 6)"


def refuse_later_fields(cfg) -> None:
    """Raise for a config field of a decoder family (GPT-NeoX, GPT-J,
    GPT-Neo, OPT, Falcon, BLOOM) that its serving slice does not take."""
    if cfg.fused_head_loss_chunk > 0:
        raise NotImplementedError(f"{type(cfg).__name__}.fused_head_loss_chunk belongs to {LATER_SLICE}")


@torch.no_grad()
def init_decoder(model: torch.nn.Module, generator: Optional[torch.Generator],
                 tables: Tuple[str, ...], position_tables: Tuple[str, ...] = ()) -> None:
    """The families' random init (their JAX modules' initializers): normal
    0.02 for the token ``tables`` and every ``kernel``, 0.01 for the learned
    ``position_tables``; biases stay zero and norm scales one, as built.
    Draws in the order of the state dict, from ``generator`` (a fresh one
    seeded 0 when None)."""
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    for name in tables:
        dense_init()(getattr(model, name), generator)
    for name in position_tables:
        dense_init(0.01)(getattr(model, name), generator)
    for name, t in model.named_parameters():
        if name.endswith(".kernel"):
            dense_init()(t, generator)


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
