"""Block-sparse flash attention on Hopper: K6, the forward kernel
(``csrc/sparse_fwd.cu``) and its backward (``csrc/sparse_bwd.cu``), each
beside its plain PyTorch version, tied together by :class:`SparseAttention`.

Counterpart of the kernels of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``: ``_sp_fwd``
(:147), ``_sp_bwd`` (:171) and the custom VJP ``_sparse_attention_bhld``
(:217-232). Tensors are ``[batch, length, heads, head_dim]`` (BLHD), as at
the JAX public boundary; the kernels read q, k, v and dO in place through
their strides. A ``[H, L/block, L/block]`` layout reaches both versions as
the index lists of ``layout_index_lists``: ``kidx``/``kcnt`` (each query
block's active key blocks) and the transposed ``qidx``/``qcnt`` (each key
block's active query blocks), int32, padded with 0 past the count.

Both versions visit the active blocks only, never a padded list entry, so a
NaN planted in a block the layout leaves dead never enters a product. Under
``causal`` they also skip every block wholly above the diagonal (the JAX
kernel visits such a block; a query block whose every active block lies
above the diagonal then reads keys that come after it, while the JAX
package's own test holds such rows to zero, the contract kept here). A row
with no live (query, key) pair gives O = 0, ``lse = NEG_INF`` (JAX's sparse
convention; the flash kernels use ``NEG_INF / 2``) and zero gradients.

On a CPU tensor a wrapper computes its plain version; on a CUDA tensor it
launches its kernel or raises. The plain versions take any head dim and
block; the kernels take head dim 64, blocks 16, 32, 64 and 128, fp32 or
bf16. bf16 runs on the tensor cores, whose 16-byte loads need q, k, v and
dO to start 16-byte aligned with strides that are multiples of 8 elements
(``ValueError`` otherwise, no copy, as K1 and K4); fp32 runs FMA bodies.
The bf16 bodies take the rows each warp group owns in the order an
optional :func:`launch_order` gives (longest list first); without one, in
natural order, with the same result.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda import LAUNCHES
from deepspeed_tpu_torch.ops.cuda import build
from deepspeed_tpu_torch.ops.cuda.attention_geometry import SPARSE_HEAD_DIMS
from deepspeed_tpu_torch.ops.cuda.flash_attention import _check_tensor_core_operands
from deepspeed_tpu_torch.ops.transformer.attention import NEG_INF
from deepspeed_tpu_torch.utils.autograd import once_differentiable

#: layout blocks the kernels are instantiated for
KERNEL_BLOCKS = (16, 32, 64, 128)

#: rows of one list group of the bf16 bodies (``csrc/sparse_attention.cuh``
#: ``MmaGeo::kUnitRows``): a layout block, or half of a 128 block; four
#: groups of 16 rows, two of 32 or one of 64 share a thread block
UNIT_ROWS = 64


def launch_order(cnt, block: int) -> np.ndarray:
    """Longest-first unit order of the bf16 bodies, from one side's list
    lengths ``cnt`` [H, L / block] or [H, L / block, 1] (``kcnt`` for the
    forward and dq passes, ``qcnt`` for dk/dv): int32 ``h * n_units + unit`` of every
    (head, unit) once, a unit being a layout block (half of one at block
    128), by its list length, ties in natural order. The kernels give
    consecutive entries to the list groups of one thread block, so those
    walk lists of like length, and run all batches of one thread block's
    entries before the next, so the few long lists (global rows and
    columns) start in the first wave instead of trailing the last. Under
    ``causal`` the kernels skip list entries above the diagonal, which the
    counts still hold: the order is a schedule, not part of the result."""
    cnt = np.asarray(cnt).reshape(np.shape(cnt)[0], -1)
    work = np.repeat(cnt, max(block // UNIT_ROWS, 1), axis=1)
    return np.argsort(-work.reshape(-1), kind="stable").astype(np.int32)


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, in dense PyTorch over the active
# blocks only)
# ---------------------------------------------------------------------------
def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """[B, L, H, D] → fp32 [B, H, L / block, block, D]."""
    b, l, h, d = x.shape
    return x.float().transpose(1, 2).reshape(b, h, l // block, block, d)


def _gather(xb: torch.Tensor, idx: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Blocks ``xb[:, h, idx[h, r, a]]`` of ``xb`` [B, H, n, ...] as [B, H,
    R, A, ...], zero where ``live`` [H, R, A] is false: the values are
    masked, not only the products, so a NaN in a dead block stays out."""
    heads = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    got = xb[:, heads, idx.long()]
    mask = live.reshape(live.shape + (1,) * (got.dim() - 4))
    return torch.where(mask, got, torch.zeros((), device=got.device))


def _live_entries(idx: torch.Tensor, cnt: torch.Tensor, causal: bool, query_side: bool) -> torch.Tensor:
    """[H, R, A] bool: list entry ``a`` of row ``r`` is counted and, under
    ``causal``, not wholly above the diagonal (a key block ``j <= r`` for a
    query block ``r``; a query block ``i >= r`` for a key block ``r``)."""
    a = torch.arange(idx.shape[-1], device=idx.device)
    live = a[None, None, :] < cnt.long()
    if causal:
        r = torch.arange(idx.shape[1], device=idx.device)[None, :, None]
        live = live & ((idx <= r) if query_side else (idx >= r))
    return live


def _pair_mask(idx: torch.Tensor, entries: torch.Tensor, block: int, causal: bool,
               query_side: bool) -> torch.Tensor:
    """[H, R, block, A, block] bool of the live (row, entry key) pairs of
    each block row ``R``: query rows against key entries when
    ``query_side``, key rows against query entries otherwise."""
    live = entries[:, :, None, :, None].expand(-1, -1, block, -1, block)
    if not causal:
        return live
    dev = idx.device
    own = (torch.arange(idx.shape[1], device=dev)[:, None] * block
           + torch.arange(block, device=dev)[None, :])                       # [R, blk]
    other = idx.long()[..., None] * block + torch.arange(block, device=dev)  # [H, R, A, blk]
    own = own[None, :, :, None, None]
    other = other[:, :, None, :, :]
    return live & ((other <= own) if query_side else (other >= own))


def _check_block(what: str, l: int, block: int) -> None:
    if block <= 0 or l % block != 0:
        raise ValueError(f"{what}: length {l} must be a multiple of the layout block {block}")


def sparse_fwd_plain(q, k, v, kidx, kcnt, *, scale: float, causal: bool,
                     block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6's forward: ``(o [B, L, H, D] in q's dtype, lse
    [B, H, L] fp32)`` of each query block's attention over the key blocks
    ``kidx[h, qb, :kcnt[h, qb]]``."""
    b, l, h, d = q.shape
    _check_block("sparse_fwd", l, block)
    dev = q.device
    kidx, kcnt = kidx.to(dev), kcnt.to(dev)
    entries = _live_entries(kidx, kcnt, causal, query_side=True)             # [H, n, A]
    kg = _gather(_blocks(k, block), kidx, entries)                           # [B, H, n, A, blk, D]
    vg = _gather(_blocks(v, block), kidx, entries)
    s = torch.einsum("bhnrd,bhnacd->bhnrac", _blocks(q, block) * scale, kg)
    valid = _pair_mask(kidx, entries, block, causal, query_side=True)[None]
    s = s.flatten(-2)
    valid = valid.flatten(-2).expand(s.shape)
    m = s.masked_fill(~valid, NEG_INF).amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros((), device=dev))
    l_sum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhnrk,bhnkd->bhnrd", p, vg.flatten(3, 4)) / l_sum.clamp_min(1e-37)
    lse = torch.where(l_sum > 0, m + torch.log(l_sum.clamp_min(1e-37)),
                      torch.full((), NEG_INF, device=dev))
    o = o.reshape(b, h, l, d).transpose(1, 2).to(q.dtype)
    return o, lse.reshape(b, h, l)


def sparse_bwd_plain(q, k, v, o, lse, do, kidx, kcnt, qidx, qcnt, *, scale: float, causal: bool,
                     block: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K6's backward, in its two passes: ``delta =
    rowsum(dO * O)``; dq per query block over ``kidx``; dk, dv per key block
    over ``qidx``. ``p = exp(s - lse)`` and ``ds = p (dp - delta)`` on live
    pairs only (0 elsewhere); ``dq = ds k * scale`` in q's dtype, ``dk = ds^T
    (q * scale)`` and ``dv = p^T dO`` in k's and v's."""
    b, l, h, d = q.shape
    _check_block("sparse_bwd", l, block)
    dev = q.device
    zero = torch.zeros((), device=dev)
    kidx, kcnt, qidx, qcnt = (t.to(dev) for t in (kidx, kcnt, qidx, qcnt))
    qs = _blocks(q, block) * scale
    dob = _blocks(do, block)
    kb, vb = _blocks(k, block), _blocks(v, block)
    n = l // block
    lse_b = lse.float().reshape(b, h, n, block)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(b, h, n, block)

    # dq: each query block over its key blocks
    entries = _live_entries(kidx, kcnt, causal, query_side=True)
    kg, vg = _gather(kb, kidx, entries), _gather(vb, kidx, entries)
    valid = _pair_mask(kidx, entries, block, causal, query_side=True)[None]  # [1,H,n,blk,A,blk]
    s = torch.einsum("bhnrd,bhnacd->bhnrac", qs, kg)
    p = torch.where(valid, torch.exp(s - lse_b[..., None, None]), zero)
    dp = torch.einsum("bhnrd,bhnacd->bhnrac", dob, vg)
    ds = torch.where(valid, p * (dp - delta[..., None, None]), zero)
    dq = torch.einsum("bhnrac,bhnacd->bhnrd", ds, kg) * scale
    del kg, vg, s, p, dp, ds

    # dk, dv: each key block over its query blocks
    entries = _live_entries(qidx, qcnt, causal, query_side=False)
    qg, dog = _gather(qs, qidx, entries), _gather(dob, qidx, entries)       # [B, H, n, A, blk, D]
    lse_g, delta_g = _gather(lse_b, qidx, entries), _gather(delta, qidx, entries)
    valid = _pair_mask(qidx, entries, block, causal, query_side=False)[None]  # [1,H,n,kr,A,qr]
    s = torch.einsum("bhnaid,bhnjd->bhnjai", qg, kb)
    p = torch.where(valid, torch.exp(s - lse_g[:, :, :, None]), zero)
    dp = torch.einsum("bhnaid,bhnjd->bhnjai", dog, vb)
    ds = torch.where(valid, p * (dp - delta_g[:, :, :, None]), zero)
    dv = torch.einsum("bhnjai,bhnaid->bhnjd", p, dog)
    dk = torch.einsum("bhnjai,bhnaid->bhnjd", ds, qg)

    def blhd(x, dtype):
        return x.reshape(b, h, l, d).transpose(1, 2).to(dtype)

    return blhd(dq, q.dtype), blhd(dk, k.dtype), blhd(dv, v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_operands(what, q, k, v, block):
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"{what}: q, k and v must lie on one CUDA device")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"{what}: q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    build.dtype_code(q, what)
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{what}: q, k, v must be [B, L, H, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{what}: head_dim must be the unit-stride axis")
    if q.shape[-1] not in SPARSE_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {q.shape[-1]} not in the kernel's {SPARSE_HEAD_DIMS}")
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"{what}: layout block {block} not in the kernel's {KERNEL_BLOCKS}")
    _check_block(what, q.shape[1], block)


def _order_operand(what, order, h, l, block, device):
    if order is None:
        return None
    n = h * (l // min(block, UNIT_ROWS))
    if order.shape != (n,) or order.device != device or order.dtype != torch.int32:
        raise ValueError(f"{what}: a launch order must be [{n}] int32 on {device}, got "
                         f"{tuple(order.shape)} {order.dtype} on {order.device}")
    return order.contiguous()


def _list_operands(what, idx, cnt, h, n, device):
    if idx.dim() != 3 or idx.shape[:2] != (h, n) or cnt.shape != (h, n, 1):
        raise ValueError(f"{what}: index lists must be [{h}, {n}, max] and [{h}, {n}, 1], got "
                         f"{tuple(idx.shape)} and {tuple(cnt.shape)}")
    for t in (idx, cnt):
        if t.device != device or t.dtype != torch.int32:
            raise ValueError(f"{what}: index lists must be int32 on {device}, got {t.dtype} on {t.device}")
    return idx.contiguous(), cnt.contiguous()


def sparse_fwd(q, k, v, kidx, kcnt, *, scale: float, causal: bool, block: int,
               order: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 forward: ``(o [B, L, H, D], lse [B, H, L] fp32)`` of block-sparse
    attention over the active key blocks ``kidx`` / ``kcnt``; ``order`` is
    :func:`launch_order` of ``kcnt`` on the device, or None."""
    if q.device.type == "cpu":
        return sparse_fwd_plain(q, k, v, kidx, kcnt, scale=scale, causal=causal, block=block)
    _check_operands("sparse_fwd", q, k, v, block)
    if q.dtype == torch.bfloat16:
        _check_tensor_core_operands("sparse_fwd", q=q, k=k, v=v)
    b, l, h, d = q.shape
    kidx, kcnt = _list_operands("sparse_fwd", kidx, kcnt, h, l // block, q.device)
    order = _order_operand("sparse_fwd", order, h, l, block, q.device)
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    lib = build.load("sparse_fwd")
    lib(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), kidx.data_ptr(),
        kcnt.data_ptr(), build.ptr(order), build.dtype_code(q, "sparse_fwd"), b, h, l, d, block,
        kidx.shape[-1], float(scale), int(bool(causal)), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], build.stream_ptr(q.device))
    LAUNCHES["sparse_fwd"] += 1
    return o, lse


def sparse_bwd(q, k, v, o, lse, do, kidx, kcnt, qidx, qcnt, *, scale: float, causal: bool,
               block: int, q_order: Optional[torch.Tensor] = None,
               k_order: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 backward: ``(dq, dk, dv)`` of :func:`sparse_fwd`'s output given
    its ``o``, ``lse`` and the output cotangent ``do``: one delta pre-pass,
    then dq over ``kidx`` and dk/dv over ``qidx``, one launch counted.
    ``q_order`` / ``k_order`` are :func:`launch_order` of ``kcnt`` / ``qcnt``
    on the device, or None."""
    if q.device.type == "cpu":
        return sparse_bwd_plain(q, k, v, o, lse, do, kidx, kcnt, qidx, qcnt, scale=scale,
                                causal=causal, block=block)
    _check_operands("sparse_bwd", q, k, v, block)
    b, l, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device or do.stride(-1) != 1:
        raise ValueError(f"sparse_bwd: do must match q [B, L, H, D] {q.dtype} with unit-stride "
                         f"head_dim, got {tuple(do.shape)} {do.dtype}")
    if q.dtype == torch.bfloat16:
        _check_tensor_core_operands("sparse_bwd", q=q, k=k, v=v, do=do)
    if o.shape != q.shape or o.dtype != q.dtype or not o.is_contiguous():
        raise ValueError("sparse_bwd: o must be the forward's contiguous [B, L, H, D] output")
    if lse.shape != (b, h, l) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("sparse_bwd: lse must be the forward's contiguous [B, H, L] fp32 output")
    n = l // block
    kidx, kcnt = _list_operands("sparse_bwd", kidx, kcnt, h, n, q.device)
    qidx, qcnt = _list_operands("sparse_bwd", qidx, qcnt, h, n, q.device)
    q_order = _order_operand("sparse_bwd", q_order, h, l, block, q.device)
    k_order = _order_operand("sparse_bwd", k_order, h, l, block, q.device)
    dq = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, l, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, l, h, d), dtype=v.dtype, device=q.device)
    delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    lib = build.load("sparse_bwd")
    lib(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        kidx.data_ptr(), kcnt.data_ptr(), qidx.data_ptr(), qcnt.data_ptr(), build.ptr(q_order),
        build.ptr(k_order), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        build.dtype_code(q, "sparse_bwd"), b, h, l, d, block, kidx.shape[-1], qidx.shape[-1],
        float(scale), int(bool(causal)), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *do.stride()[:3], build.stream_ptr(q.device))
    LAUNCHES["sparse_bwd"] += 1
    return dq, dk, dv


class SparseAttention(torch.autograd.Function):
    """K6 forward, K6 backward: the port of the custom VJP
    ``_sparse_attention_bhld`` with ``_sparse_fwd_rule`` /
    ``_sparse_bwd_rule`` (JAX ``sparse_self_attention.py:217-232``), over
    BLHD tensors, with the launch orders of the query and key side (or
    None). It saves ``o`` and ``lse`` for the backward. Differentiable once,
    as JAX's ``custom_vjp``: a second derivative raises."""

    @staticmethod
    def forward(ctx, q, k, v, kidx, kcnt, qidx, qcnt, q_order, k_order, scale, causal, block):
        o, lse = sparse_fwd(q, k, v, kidx, kcnt, scale=scale, causal=causal, block=block,
                            order=q_order)
        ctx.save_for_backward(q, k, v, o, lse, kidx, kcnt, qidx, qcnt, q_order, k_order)
        ctx.args = (scale, causal, block)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, kidx, kcnt, qidx, qcnt, q_order, k_order = ctx.saved_tensors
        scale, causal, block = ctx.args
        if do.stride(-1) != 1:  # e.g. the expanded cotangent of a sum
            do = do.contiguous()
        dq, dk, dv = sparse_bwd(q, k, v, o, lse, do, kidx, kcnt, qidx, qcnt, scale=scale,
                                causal=causal, block=block, q_order=q_order, k_order=k_order)
        return (dq, dk, dv) + (None,) * 9
