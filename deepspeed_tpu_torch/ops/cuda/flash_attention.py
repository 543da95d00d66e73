"""Flash attention on Hopper: K1, the forward kernel (``csrc/flash_fwd.cu``),
K4, its backward (``csrc/flash_bwd.cu``), and K3, the decode kernel
(``csrc/flash_decode.cu``), each beside its plain PyTorch version, plus the
``"flash"`` attention backend.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``. Layout at
the public boundary is ``[batch, length, heads, head_dim]`` (BLHD), as in
the JAX package; the kernels read it in place through strides.

On a CPU tensor a wrapper computes its plain version; on a CUDA tensor it
launches the kernel or raises. K1 and K4 run bf16 on the tensor cores (K1
carries p as a bf16 hi + lo pair into its second product, K4 rounds p and
ds to bf16) and fp32 as FMAs, at head dim 64 or 128 (any other raises
``ValueError`` before anything is built or launched); a bf16 tensor whose
rows are not 16-byte aligned raises ``ValueError``. K3 splits the cache
over thread blocks and reads it either as values of q's dtype or as the
int8 KV pool's codes with their scales, dequantised on read
(:func:`flash_decode`). The JAX backend
falls back to XLA for a bias, an arbitrary mask or dropout; this backend
raises instead, so the main path can never leave the kernel quietly. The backend goes through
:class:`FlashAttention`, the ``torch.autograd.Function`` that ties K1 to
K4 (the JAX custom VJP ``_flash_attention_bhld``), so one call serves
inference (no graph is recorded) and training.
"""

from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.cuda import LAUNCHES
from deepspeed_tpu_torch.ops.cuda import build
from deepspeed_tpu_torch.ops.cuda.attention_geometry import (DECODE_BODIES, DECODE_CHUNK,
                                                              check_head_dim, decode_body)
from deepspeed_tpu_torch.ops.transformer.attention import NEG_INF, register_backend


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, in dense PyTorch)
# ---------------------------------------------------------------------------
def _masked_softmax_av(s, valid, v):
    """Online-softmax result in one pass: masked logits give an explicit 0,
    so a row with no live key has l = 0 and returns zeros."""
    m = s.masked_fill(~valid, NEG_INF).amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros((), device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / l.clamp_min(1e-37)
    return o, m, l


def live_pairs(lq, lk, causal, kv_lengths, window, dev) -> torch.Tensor:
    """[B or 1, 1, Lq, Lk] mask of the (query, key) pairs attention reads:
    query i sits at position ``i + Lk - Lq``."""
    q_pos = torch.arange(lq, device=dev)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=dev)[None, :]
    valid = torch.ones((lq, lk), dtype=torch.bool, device=dev)
    if causal:
        valid = valid & (k_pos <= q_pos)
    if window is not None:
        valid = valid & (k_pos > q_pos - window)
    valid = valid[None, None]
    if kv_lengths is not None:
        valid = valid & (k_pos[None, None] < kv_lengths.to(dev).long()[:, None, None, None])
    return valid


def flash_fwd_plain(q, k, v, *, scale: float, causal: bool,
                    kv_lengths: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: ``(o [B, Lq, H, D] in q's dtype, lse [B, H, Lq]
    fp32)``. Query i sits at position ``i + Lk - Lq``; rows with no live key
    give O = 0 and lse = NEG_INF / 2."""
    lq, lk = q.shape[1], k.shape[1]
    dev = q.device
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    valid = live_pairs(lq, lk, causal, kv_lengths, window, dev)
    o, m, l = _masked_softmax_av(s, valid, v)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-37)),
                      torch.full((), NEG_INF / 2, device=dev))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def flash_bwd_plain(q, k, v, o, lse, do, *, scale: float, causal: bool,
                    kv_lengths: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K4, the FlashAttention-2 backward over BLHD tensors:
    ``delta = rowsum(dO * O)``, ``p = exp(s - lse)`` on live pairs (0
    elsewhere, so a row with no live key has zero gradients), ``ds = p (dp -
    delta)``; ``dq = ds k * scale`` in q's dtype, ``dk = ds^T (q * scale)``
    and ``dv = p^T dO`` in k's and v's."""
    lq, lk = q.shape[1], k.shape[1]
    qf = q.float() * scale
    kf, vf, dof = k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    valid = live_pairs(lq, lk, causal, kv_lengths, window, q.device)
    p = torch.where(valid, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # [B, H, Lq]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 KV codes [S, P, H, D] times their per-(slot, position, head)
    scales [S, P, H, 1], in ``dtype``: the pool K3's int8 form reads (the
    serving model's dequantise-on-read, ``models/gpt2.py``)."""
    return codes.to(dtype) * scale


def flash_decode_plain(q, k, v, lengths: torch.Tensor, *, scale: float,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K3: row i of slot s sits at position
    ``lengths[s] - Lq + i`` and sees cache positions at or before it, inside
    ``min(lengths[s], P)``; rows with no live key, and length 0, give 0.
    With ``k_scale``/``v_scale``, k and v are int8 codes, dequantised first
    (:func:`dequantize_kv`)."""
    if k_scale is not None:
        k, v = dequantize_kv(k, k_scale, q.dtype), dequantize_kv(v, v_scale, q.dtype)
    lq = q.shape[1]
    p_len = k.shape[1]
    dev = q.device
    lengths = lengths.to(dev).long()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    q_pos = lengths[:, None] - lq + torch.arange(lq, device=dev)[None, :]        # [S, Lq]
    k_pos = torch.arange(p_len, device=dev)
    n_live = lengths.clamp(0, p_len)
    valid = (k_pos[None, None, :] <= q_pos[:, :, None]) & (k_pos[None, None, :] < n_live[:, None, None])
    o, _, _ = _masked_softmax_av(s, valid[:, None], v)
    return o.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_operands(what, q, k, v):
    check_head_dim(what, q.shape[-1])  # first: a head dim without a kernel never reaches the build
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"{what}: q, k and v must lie on one CUDA device")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"{what}: q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    build.dtype_code(q, what)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: expected [B, L, H, D] tensors")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{what}: head_dim must be the unit-stride axis")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")


def _check_tensor_core_operands(what, **tensors):
    """The bf16 bodies of K1 and K4 load rows with 16-byte ``cp.async``: each
    tensor must start on a 16-byte boundary and step through its batch,
    length and head axes in multiples of 8 elements (an axis of size 1 is
    never stepped through)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(st % 8 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"{what}: bf16 {name} must start 16-byte aligned with batch, "
                             f"length and head strides that are multiples of 8 elements; got "
                             f"address offset {t.data_ptr() % 16} bytes, strides {t.stride()}")


def _lengths_operand(what, lengths, b, device):
    if lengths.shape != (b,):
        raise ValueError(f"{what}: lengths must be [{b}], got {tuple(lengths.shape)}")
    if lengths.device != device or lengths.dtype != torch.int32:
        raise ValueError(f"{what}: lengths must be int32 on {device}, got "
                         f"{lengths.dtype} on {lengths.device}")
    return lengths.contiguous()


def flash_fwd(q, k, v, *, scale: float, causal: bool,
              kv_lengths: Optional[torch.Tensor] = None,
              window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: ``(o [B, Lq, H, D], lse [B, H, Lq] fp32)`` of attention with an
    optional causal mask (offset ``Lk - Lq``), right-padding
    ``kv_lengths`` [B] and sliding ``window``."""
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(f"causal flash attention needs lq <= lk, got {q.shape[1]} > {k.shape[1]}")
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale=scale, causal=causal,
                               kv_lengths=kv_lengths, window=window)
    _check_operands("flash_fwd", q, k, v)
    if q.dtype == torch.bfloat16:
        _check_tensor_core_operands("flash_fwd", q=q, k=k, v=v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    lens = None if kv_lengths is None else _lengths_operand("flash_fwd", kv_lengths, b, q.device)
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_fwd")
    lib(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), build.ptr(lens),
        build.dtype_code(q, "flash_fwd"), b, h, lq, lk, d, float(scale), int(bool(causal)),
        int(window) if window is not None else 0,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], build.stream_ptr(q.device))
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd(q, k, v, o, lse, do, *, scale: float, causal: bool,
              kv_lengths: Optional[torch.Tensor] = None,
              window: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: ``(dq, dk, dv)`` of :func:`flash_fwd`'s output given its
    ``o``, ``lse`` and the output cotangent ``do``. q, k, v and do are read
    through their strides; o and lse are K1's contiguous outputs."""
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(f"causal flash attention needs lq <= lk, got {q.shape[1]} > {k.shape[1]}")
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, scale=scale, causal=causal,
                               kv_lengths=kv_lengths, window=window)
    _check_operands("flash_bwd", q, k, v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device or do.stride(-1) != 1:
        raise ValueError(f"flash_bwd: do must match q [B, Lq, H, D] {q.dtype} with unit-stride "
                         f"head_dim, got {tuple(do.shape)} {do.dtype}")
    if q.dtype == torch.bfloat16:
        _check_tensor_core_operands("flash_bwd", q=q, k=k, v=v, do=do)
    if o.shape != q.shape or o.dtype != q.dtype or not o.is_contiguous():
        raise ValueError("flash_bwd: o must be K1's contiguous [B, Lq, H, D] output")
    if lse.shape != (b, h, lq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_bwd: lse must be K1's contiguous [B, H, Lq] fp32 output")
    lens = None if kv_lengths is None else _lengths_operand("flash_bwd", kv_lengths, b, q.device)
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, lk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, lk, h, d), dtype=v.dtype, device=q.device)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_bwd")
    lib(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        build.ptr(lens), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        build.dtype_code(q, "flash_bwd"), b, h, lq, lk, d, float(scale), int(bool(causal)),
        int(window) if window is not None else 0,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        build.stream_ptr(q.device))
    LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv


#: ``policy`` of :class:`FlashAttention`: keep K1's log-sum-exp for the
#: backward, or drop it and re-run K1 there to regenerate it
POLICIES = ("lse", "recompute")


class FlashAttention(torch.autograd.Function):
    """K1 forward, K4 backward: the port's ``_flash_attention_bhld``
    (``deepspeed_tpu/ops/pallas/flash_attention.py:515-546``), over BLHD
    tensors. ``policy="recompute"`` saves no lse and re-runs K1 in the
    backward. The JAX kernel's block sizes and ``bwd_skip`` are TPU grid
    policy: the Hopper loops always skip dead tiles, which gives the result
    of both JAX settings."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, scale, causal, window, policy):
        o, lse = flash_fwd(q, k, v, scale=scale, causal=causal, kv_lengths=kv_lengths,
                           window=window)
        ctx.save_for_backward(q, k, v, o, lse if policy == "lse" else None, kv_lengths)
        ctx.args = (scale, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lengths = ctx.saved_tensors
        scale, causal, window = ctx.args
        if lse is None:
            _, lse = flash_fwd(q, k, v, scale=scale, causal=causal, kv_lengths=kv_lengths,
                               window=window)
        if do.stride(-1) != 1:  # e.g. the expanded cotangent of a sum
            do = do.contiguous()
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, scale=scale, causal=causal,
                               kv_lengths=kv_lengths, window=window)
        return dq, dk, dv, None, None, None, None, None


def _check_decode_operands(q, k, v, k_scale, v_scale):
    """K3's operands: values of q's dtype, or int8 codes with scales
    [S, P, H, 1] of q's dtype. K and V stream as 16-byte vectors, so each
    must start 16-byte aligned and step through slots, positions and heads
    in multiples of 16 bytes; the bf16 tile body loads q with cp.async too
    (K1's rule). Nothing is copied: what does not fit raises."""
    what = "flash_decode"
    check_head_dim(what, q.shape[-1])  # first: a head dim without a kernel never reaches the build
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: pass both k_scale and v_scale (int8 KV) or neither")
    tensors = (q, k, v) if k_scale is None else (q, k, v, k_scale, v_scale)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: q, k, v (and scales) must lie on one CUDA device")
    build.dtype_code(q, what)
    kv_dtype = q.dtype if k_scale is None else torch.int8
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise ValueError(f"{what}: k and v must be {kv_dtype} for q {q.dtype}"
                         f"{'' if k_scale is None else ' with scales'}, got {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: expected [S, L, H, D] tensors")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{what}: head_dim must be the unit-stride axis")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if k_scale is not None:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != k.shape[:3] + (1,) or t.dtype != q.dtype:
                raise ValueError(f"{what}: {name} must be {q.dtype} {tuple(k.shape[:3]) + (1,)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"{what}: {name} must start 16-byte aligned with slot, position and "
                             f"head strides of whole 16 bytes; got address offset "
                             f"{t.data_ptr() % 16} bytes, strides {t.stride()}")


def flash_decode(q, k, v, lengths: torch.Tensor, *, scale: Optional[float] = None,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: length-masked attention of ``q`` [S, Lq, H, D] (each slot's
    newest Lq tokens) against a cache [S, P, H, D] with ``lengths`` [S]
    live positions per slot. With ``k_scale``/``v_scale`` [S, P, H, 1] in
    q's dtype, k and v are int8 codes that the kernel dequantises on read,
    exactly as :func:`dequantize_kv` does, so it gives the bits of the call
    on the dequantised pool."""
    if scale is None:
        scale = q.shape[-1]**-0.5
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, scale=scale, k_scale=k_scale, v_scale=v_scale)
    _check_decode_operands(q, k, v, k_scale, v_scale)
    s, lq, h, d = q.shape
    p_len = k.shape[1]
    body = decode_body(q.dtype == torch.bfloat16, lq)
    if body == "tiles":
        _check_tensor_core_operands("flash_decode", q=q)
    lens = _lengths_operand("flash_decode", lengths, s, q.device)
    o = torch.empty((s, lq, h, d), dtype=q.dtype, device=q.device)
    chunks = -(-p_len // DECODE_CHUNK[body])
    ws = torch.empty(s * h * lq * chunks * (d + 2), dtype=torch.float32, device=q.device)
    scale_strides = [0] * 6 if k_scale is None else [*k_scale.stride()[:3], *v_scale.stride()[:3]]
    lib = build.load("flash_decode")
    lib(q.data_ptr(), k.data_ptr(), v.data_ptr(), build.ptr(k_scale), build.ptr(v_scale),
        lens.data_ptr(), o.data_ptr(), ws.data_ptr(), build.counters(q.device, s * h * lq).data_ptr(),
        build.dtype_code(q, "flash_decode"), DECODE_BODIES.index(body), s, h, lq, p_len, d,
        float(scale), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *scale_strides,
        build.stream_ptr(q.device))
    LAUNCHES["flash_decode"] += 1
    return o


@register_backend("flash")
def flash_attention(q: torch.Tensor,
                    k: torch.Tensor,
                    v: torch.Tensor,
                    *,
                    causal: bool = True,
                    bias: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    decode_lengths: Optional[torch.Tensor] = None,
                    kv_lengths: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    policy: str = "lse",
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention over BLHD tensors: K3 when ``decode_lengths`` is
    given (cache decode; with ``k_scale``/``v_scale``, k and v are the int8
    KV pool's codes), else K1 with K4 as its backward
    (:class:`FlashAttention`). A bias, an arbitrary mask or dropout raise
    ``ValueError``: use the ``"xla"`` backend for those."""
    del generator  # dropout is refused below; the argument mirrors the plain backend
    if bias is not None or mask is not None or dropout_rate > 0.0:
        raise ValueError("the flash backend takes no bias, mask or dropout; use backend='xla'")
    if policy not in POLICIES:
        raise ValueError(f"unknown flash backward policy {policy!r}; expected one of {POLICIES}")
    if decode_lengths is not None and kv_lengths is not None:
        raise ValueError("pass decode_lengths (cache decode) or kv_lengths "
                         "(padded prefill), not both")
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires causal=True")
    if window is not None and decode_lengths is not None:
        raise ValueError("window is a prefill/training feature; the decode path "
                         "attends the whole cache")
    if scale is None:
        scale = q.shape[-1]**-0.5
    if k_scale is not None and decode_lengths is None:
        raise ValueError("k_scale/v_scale (int8 KV codes) are a cache-decode operand: "
                         "pass decode_lengths")
    if decode_lengths is not None:
        return flash_decode(q, k, v, decode_lengths, scale=scale, k_scale=k_scale,
                            v_scale=v_scale)
    return FlashAttention.apply(q, k, v, kv_lengths, float(scale), bool(causal),
                                None if window is None else int(window), policy)
