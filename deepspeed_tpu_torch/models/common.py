"""Shared model helpers (the serving and training subset of
``deepspeed_tpu/models/common.py``)."""

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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
    the ``remat_every`` stride, else ``block`` itself. Full recompute only
    (the JAX package's saveable-op ``remat_policy`` belongs to the
    activation-checkpointing slice; ``GPT2Config`` refuses it). Runs the
    block plainly when no graph is recorded (inference)."""
    enabled = getattr(cfg, "remat", False) if enabled is None else enabled
    if not enabled or layer_idx % max(getattr(cfg, "remat_every", 1), 1) != 0:
        return block

    def run(*args):
        if not torch.is_grad_enabled():
            return block(*args)
        return checkpoint(block, *args, use_reentrant=False)

    return run


class _FusedLMHeadLoss(torch.autograd.Function):
    """Chunked LM head + mean cross-entropy that never builds [B, T, V]:
    the forward keeps one chunk's logits at a time and only sums the NLL;
    the backward recomputes each chunk's logits and feeds ``(softmax -
    onehot) * valid * g / denom``, cast to x's dtype, into the two products.
    Port of ``_fused_lm_head_loss_fn`` (``models/common.py:292-399``), whose
    chunk loop was a ``lax.scan``. The head is the tied ``[V, E]`` table
    (``vocab_major``, GPT-2) or an untied ``[E, V]`` kernel (LLaMA); each
    layout contracts its own axis, with no transposed copy."""

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
        for lo in range(0, x_f.shape[0], chunk):
            x_c, lab_c = x_f[lo:lo + chunk], lab_f[lo:lo + chunk]
            logits = _FusedLMHeadLoss._logits(x_c, w, vocab_major)
            valid = lab_c != ignore_index
            safe = torch.where(valid, lab_c, torch.zeros_like(lab_c))
            coeff32 = torch.softmax(logits.float(), dim=-1)
            coeff32.scatter_add_(-1, safe[:, None], torch.full_like(coeff32[:, :1], -1.0))
            coeff32 = coeff32 * (valid * scale)[:, None]
            coeff = coeff32.to(x.dtype)
            # dx: fp32 accumulation rounded once to x's dtype; dw: fp32 sums
            # of the exact products of the x-dtype operands
            if vocab_major:
                dx_chunks.append(coeff @ w)
                dw += coeff.t().float() @ x_c.float()
            else:
                dx_chunks.append(coeff @ w.t())
                dw += x_c.t().float() @ coeff.float()
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
