"""Dequantisation fused into the GEMM on Hopper: K2 (``csrc/quant_matmul.cu``)
beside its plain PyTorch version.

Counterpart of ``deepspeed_tpu/ops/pallas/quant_matmul.py``. The served
kernel arrives as int8 codes (int4: two per byte along the contraction
axis, ``ops/quantizer/weights.py`` layout) plus per-(K-group, output column)
fp32 scales ``[G, N]``; the kernel reads the codes and expands them only in
registers or shared memory. On a CPU tensor the wrapper computes the plain
version (the JAX package's ``_xla_quant_matmul``); on a CUDA tensor it
launches the kernel or raises. The kernel has three bodies, picked by
:func:`qmm_body` from x's dtype, M and the operands' layout.
"""

import torch

from deepspeed_tpu_torch.ops.cuda import LAUNCHES
from deepspeed_tpu_torch.ops.cuda import build
from deepspeed_tpu_torch.ops.cuda.attention_geometry import (QMM_BODIES, QMM_GEMV_MAX_K_CHUNK,
                                                              QMM_GEMV_MAX_M, QMM_K_STEP,
                                                              QMM_MAX_CLUSTER, QMM_TILES)
from deepspeed_tpu_torch.ops.quantizer.weights import unpack_rows

#: thread blocks to aim for when the output alone has too few tiles: two
#: per streaming multiprocessor of an H100, and for the prefill body, whose
#: blocks hold 8 warps and 101 KB of shared memory, about one and a half
TARGET_BLOCKS = {"fma": 264, "gemv": 264, "mma": 192}


def quant_matmul_plain(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                       bits: int) -> torch.Tensor:
    """Plain version of K2: dequantize the whole kernel to x's dtype, then
    an fp32-accumulated product, written in x's dtype."""
    k = x.shape[1]
    q = unpack_rows(qw) if bits == 4 else qw
    g, n = scale.shape
    w = (q.float().reshape(g, k // g, n) * scale[:, None, :]).reshape(k, n).to(x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def qmm_body(m: int, k: int, n: int, group_size: int, bf16: bool, aligned: bool) -> str:
    """K2's body for a call: on the tensor cores for bf16 x, the decode
    body up to ``QMM_GEMV_MAX_M`` rows (and K it can split into at most
    ``QMM_MAX_CLUSTER`` ranges it stages) and the prefill body otherwise,
    where N and the group size are multiples of 16 and x (rows too), codes
    and scales start 16-byte aligned (``aligned``); else the general FMA
    body, which takes any shape (and every fp32 call: an fp32 product on
    the tensor cores could not meet the fp32 checks)."""
    if not (bf16 and aligned and n % 16 == 0 and group_size % 16 == 0):
        return "fma"
    fits = k <= QMM_MAX_CLUSTER * QMM_GEMV_MAX_K_CHUNK
    return "gemv" if m <= QMM_GEMV_MAX_M and fits else "mma"


def split_k(m: int, k: int, n: int, body: str = None, bits: int = 8):
    """``(k_chunk, splits)`` for ``body`` (default: the bf16 body for M):
    split K over blocks until about ``TARGET_BLOCKS[body]`` are in flight. The
    tensor-core bodies sum a tile's splits within one thread-block cluster,
    so they take at most ``QMM_MAX_CLUSTER``; the general body's splits
    write fp32 partials to device memory, which stay under the code bytes
    (``splits * m * n * 4 <= k * n * bits / 8``). ``k_chunk`` is a multiple
    of the 64-row K step (so an int4 byte never straddles two splits); the
    decode body stages at most ``QMM_GEMV_MAX_K_CHUNK`` rows of x."""
    if body is None:
        body = "gemv" if m <= QMM_GEMV_MAX_M else "mma"
    bm, bn = QMM_TILES[body]
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-k // QMM_K_STEP)
    cap = max(1, k * bits // (32 * m)) if body == "fma" else QMM_MAX_CLUSTER
    want = max(1, min(steps, cap, -(-TARGET_BLOCKS[body] // tiles)))
    chunk_steps = -(-steps // want)
    if body == "gemv":
        chunk_steps = min(chunk_steps, QMM_GEMV_MAX_K_CHUNK // QMM_K_STEP)
    k_chunk = chunk_steps * QMM_K_STEP
    return k_chunk, -(-k // k_chunk)


def _kernel_quant_matmul(x, qw, scale, bits):
    what = "quant_matmul"
    if not (x.is_cuda and qw.is_cuda and scale.is_cuda) or len({x.device, qw.device, scale.device}) != 1:
        raise ValueError(f"{what}: x, codes and scales must lie on one CUDA device")
    if qw.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"{what}: codes must be int8 and scales float32, got {qw.dtype}, {scale.dtype}")
    code = build.dtype_code(x, what)
    if x.stride(1) != 1:
        x = x.contiguous()
    qw = qw.contiguous()
    scale = scale.contiguous()
    m, k = x.shape
    g, n = scale.shape
    aligned = x.stride(0) % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, qw, scale))
    body = qmm_body(m, k, n, k // g, x.dtype == torch.bfloat16, aligned)
    k_chunk, splits = split_k(m, k, n, body, bits)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    workspace = counters = None
    if body == "fma" and splits > 1:
        bm, bn = QMM_TILES[body]
        workspace = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
        counters = build.counters(x.device, -(-m // bm) * -(-n // bn))
    lib = build.load("quant_matmul")
    lib(x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(), build.ptr(workspace),
        build.ptr(counters), code, bits, QMM_BODIES.index(body), m, k, n,
        k // g, x.stride(0), k_chunk, splits, build.stream_ptr(x.device))
    LAUNCHES["quant_matmul"] += 1
    return out


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, *,
                 bits: int = 8) -> torch.Tensor:
    """``x [M, K] @ dequant(qw, scale) [K, N]`` -> ``[M, N]`` in x's dtype.

    ``qw`` is ``[K, N]`` int8 codes (bits=8) or ``[K/2, N]`` packed nibbles
    (bits=4, ``weights.pack_rows`` layout); ``scale`` is ``[G, N]`` fp32
    with G dividing K."""
    if bits not in (8, 4):
        raise ValueError(f"quant_matmul supports bits in (8, 4), got {bits}")
    k = x.shape[1]
    g = scale.shape[0]
    if k % g != 0:
        raise ValueError(f"group count {g} must divide K={k}")
    kw = qw.shape[0] * (2 if bits == 4 else 1)
    if kw != k:
        raise ValueError(f"code rows {qw.shape[0]}{' (x2 packed)' if bits == 4 else ''} "
                         f"do not match x's contraction K={k}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qw, scale, bits)
    return _kernel_quant_matmul(x, qw, scale, bits)


def quant_dense_general(x: torch.Tensor, qkernel: torch.Tensor, scale: torch.Tensor, *,
                        bits: int = 8, n_contract: int = 1) -> torch.Tensor:
    """Contract x's trailing ``n_contract`` dims against the quantized
    kernel's leading ``n_contract`` dims (int4: the last contraction axis
    is stored halved). Output shape is ``x.shape[:-n_contract] +
    qkernel.shape[n_contract:]``."""
    bshape = x.shape[:x.dim() - n_contract]
    k = 1
    for d in x.shape[x.dim() - n_contract:]:
        k *= d
    out_dims = qkernel.shape[n_contract:]
    n = 1
    for d in out_dims:
        n *= d
    out = quant_matmul(x.reshape(-1, k), qkernel.reshape(-1, n), scale, bits=bits)
    return out.reshape(*bshape, *out_dims)
