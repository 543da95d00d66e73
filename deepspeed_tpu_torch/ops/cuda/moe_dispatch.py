"""Row permutation for the sorted MoE dispatch/combine route on Hopper: K5
(``csrc/moe_permute.cu``) beside its plain PyTorch version.

Counterpart of ``deepspeed_tpu/ops/pallas/moe_dispatch.py``. The sorted
route (``moe/sharded_moe.py``) reduces both MoE data movements to one
primitive, a permutation of rows by a precomputed index where an index out
of range gives a zero row:

* dispatch: ``buf[j] = tokens[src[j]]``, each expert-capacity slot pulls the
  token copy routed to it (empty slots pull the zero row);
* combine: ``rows[i] = buf[flat_slot[i]]``, each token copy pulls its expert
  output back (dropped copies pull the zero row).

Capacity assignment gives every kept token copy a unique slot, so both maps
are injective on their live entries and the gradient of a gather by
``fwd_idx`` is the gather by the inverse map ``bwd_idx``: no scatter-add.

Implementations (the names are the JAX package's, so configs carry over):

* ``impl="xla"``: the plain version (clamp, gather, mask) on whatever
  device the tensors are, differentiated by autograd. Chosen explicitly.
* ``impl="pallas"``: :class:`PermuteRows`, whose forward and backward both
  go through :func:`moe_permute`: K5 on a CUDA tensor, the plain version on
  a CPU tensor, never one in place of the other.
"""

import torch

from deepspeed_tpu_torch.ops.cuda import LAUNCHES
from deepspeed_tpu_torch.ops.cuda import build
from deepspeed_tpu_torch.utils.autograd import once_differentiable

IMPL_CHOICES = ("xla", "pallas")


def resolve_impl(kernel: str) -> str:
    """Map a routing-engine kernel choice ("auto"|"xla"|"pallas") to an
    impl. ``"auto"`` is ``"pallas"``: K5 on the card (the JAX package picks
    its Pallas kernel on the TPU the same way)."""
    if kernel == "auto":
        return "pallas"
    if kernel not in IMPL_CHOICES:
        raise ValueError(f"moe kernel impl must be one of {IMPL_CHOICES} "
                         f"(or 'auto'), got {kernel!r}")
    return kernel


def _check_shapes(x: torch.Tensor, idx: torch.Tensor) -> None:
    if x.dim() != 3 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"moe_permute: x must be [G, N, M] and idx [G, R], got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise ValueError(f"moe_permute: idx must be an integer tensor, got {idx.dtype}")


def moe_permute_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (JAX ``_xla_permute``): ``x`` [G, N, M], ``idx``
    [G, R] with entries >= N meaning "zero row"; returns [G, R, M]."""
    _check_shapes(x, idx)
    n = x.shape[1]
    idx = idx.long()
    clipped = idx.clamp(max=n - 1)
    rows = torch.gather(x, 1, clipped[:, :, None].expand(-1, -1, x.shape[2]))
    return torch.where((idx < n)[:, :, None], rows, torch.zeros((), dtype=x.dtype, device=x.device))


def _kernel_permute(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    what = "moe_permute"
    if not (x.is_cuda and idx.is_cuda) or x.device != idx.device:
        raise ValueError(f"{what}: x and idx must lie on one CUDA device")
    if idx.dtype != torch.int32:
        raise ValueError(f"{what}: the CUDA kernel takes int32 indices, got {idx.dtype}")
    code = build.dtype_code(x, what, build.FP16_DTYPES)
    x = x.contiguous()
    idx = idx.contiguous()
    g, n, m = x.shape
    r = idx.shape[1]
    out = torch.empty((g, r, m), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load("moe_permute")
    lib(x.data_ptr(), idx.data_ptr(), out.data_ptr(), code, g, n, r, m, build.stream_ptr(x.device))
    LAUNCHES["moe_permute"] += 1
    return out


def moe_permute(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5: ``out[g, r] = x[g, idx[g, r]]``, a zero row where ``idx[g, r]``
    is out of ``[0, N)``. The kernel takes fp32, bf16 or fp16 ``x`` and int32
    ``idx`` on one CUDA device (non-contiguous operands are copied first);
    a CPU ``x`` gets the plain version."""
    _check_shapes(x, idx)
    if x.device.type == "cpu":
        return moe_permute_plain(x, idx)
    return _kernel_permute(x, idx)


class PermuteRows(torch.autograd.Function):
    """The gather by ``fwd_idx`` with the gather by ``bwd_idx`` as its
    backward: the port of ``_pallas_permute_vjp`` (JAX
    ``moe_dispatch.py:109-128``). The cotangent may arrive with any strides;
    :func:`moe_permute` reads it contiguous. Differentiable once, as JAX's
    ``custom_vjp``: a second derivative raises."""

    @staticmethod
    def forward(ctx, x, fwd_idx, bwd_idx):
        ctx.save_for_backward(bwd_idx)
        return moe_permute(x, fwd_idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (bwd_idx,) = ctx.saved_tensors
        return moe_permute(g.contiguous(), bwd_idx), None, None


def permute_rows(x: torch.Tensor, fwd_idx: torch.Tensor, bwd_idx: torch.Tensor, *,
                 impl: str = "xla") -> torch.Tensor:
    """Permute rows of ``x`` [G, N, M] to ``[G, R, M]`` by ``fwd_idx`` [G, R];
    indices >= N give zero rows.

    ``bwd_idx`` [G, N] must be the inverse map (``bwd_idx[g, i]`` is the
    output row that reads input row ``i``, or >= R when none does). Only
    ``impl="pallas"`` reads it, in its backward; ``"xla"`` differentiates
    the plain gather. **Both maps must be injective on their live
    entries**, which the gating's capacity assignment guarantees."""
    if impl == "pallas":
        return PermuteRows.apply(x, fwd_idx, bwd_idx)
    if impl != "xla":
        raise ValueError(f"moe dispatch impl must be one of {IMPL_CHOICES}, got {impl!r}")
    return moe_permute_plain(x, fwd_idx)


def inverse_index(fwd_idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Inverse of an injective-with-drop map: given ``fwd_idx`` [G, R] with
    live entries < ``n_rows`` unique per group, the int32 ``inv`` [G,
    n_rows] where ``inv[g, j]`` is the r with ``fwd_idx[g, r] == j``, or
    ``R`` (the drop sentinel) when no entry maps there.

    The JAX version drops out-of-range destinations from its scatter; a
    CUDA scatter out of range is a device fault, so every dead entry lands
    in one extra column that is cut off."""
    groups, r = fwd_idx.shape
    inv = torch.full((groups, n_rows + 1), r, dtype=torch.int32, device=fwd_idx.device)
    dest = fwd_idx.long().clamp(max=n_rows)
    cols = torch.arange(r, dtype=torch.int32, device=fwd_idx.device).expand(groups, r)
    inv.scatter_(1, dest, cols)
    return inv[:, :n_rows].contiguous()
