"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

These need a card (and ``nvcc`` to build the kernels) and skip elsewhere;
``chip_smoke.py`` runs the same comparisons at the serving and training
slices' full shapes. Tolerances: max |err| / max |ref| within 1e-4 in fp32 (the sums run
in another order) and 2e-2 in bf16 (outputs are rounded to bf16); K5, a gather, must equal
its plain version exactly. K6 (block-sparse attention) is held to its plain version for
every layout block the kernel takes, per-head layouts, an empty row and a NaN probe. K1, K4,
K6 and K3 (both operand forms) are also held, in fp32 and bf16, within 1e-6 of inputs whose
result is exact (``deepspeed_tpu_torch.testing.exact_probe``, ``sparse_exact_probe`` and
``decode_exact_probe``); K2's three bodies must give their plain version's bits on
``quant_matmul_probe``'s inputs, and K3's int8 form the bits of its value form on the
dequantised pool. K1, K4 and K3 run at head dims 64 and 128 (the ``_d128``
cases: the same comparisons and probes at the LLaMA family's width).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import LAUNCHES
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda import moe_dispatch as md
from deepspeed_tpu_torch.ops.cuda import quant_matmul as qm
from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (index_lists_on,
                                                                           launch_orders_on)
from deepspeed_tpu_torch.ops.quantizer.weights import pack_rows
from deepspeed_tpu_torch.testing import (decode_exact_probe, exact_probe, quant_matmul_probe,
                                        sparse_exact_probe)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, dtype):
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * max(ref.float().abs().max().item(), 1e-30)


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,causal,lengths,window", [
    (100, 100, True, None, None), (16, 130, True, None, None), (64, 64, False, [64, 9, 0], None),
    (90, 90, True, [90, 40, 1], None), (200, 200, True, None, 33)])
def test_flash_fwd_matches_plain(gen, dtype, lq, lk, causal, lengths, window):
    b = 3
    q, k, v = (_randn(gen, b, n, 4, 64, dtype=dtype) for n in (lq, lk, lk))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = LAUNCHES["flash_fwd"]
    o, lse = fa.flash_fwd(q, k, v, scale=0.125, causal=causal, kv_lengths=lens, window=window)
    assert LAUNCHES["flash_fwd"] == before + 1
    ro, rlse = fa.flash_fwd_plain(q, k, v, scale=0.125, causal=causal, kv_lengths=lens, window=window)
    _close(o, ro, dtype)
    _close(lse, rlse, torch.float32)


def _qkv(gen, b, lq, lk, dtype):
    """q, k, v as the model gives them: slices of one fused QKV tensor when
    lq == lk (not contiguous), else separate tensors."""
    if lq == lk:
        qkv = _randn(gen, b, lq, 3, 4, 64, dtype=dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return _randn(gen, b, lq, 4, 64, dtype=dtype), *(_randn(gen, b, lk, 4, 64, dtype=dtype)
                                                     for _ in range(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,causal,lengths,window", [
    (100, 100, True, None, None), (16, 130, True, None, None), (64, 64, False, [64, 9, 0], None),
    (90, 90, True, [90, 40, 1], None), (200, 200, True, None, 33), (130, 130, False, None, None)])
def test_flash_bwd_matches_plain(gen, dtype, lq, lk, causal, lengths, window):
    q, k, v = _qkv(gen, 3, lq, lk, dtype)
    do = _randn(gen, 3, lq, 4, 2, 64, dtype=dtype)[:, :, :, 0]  # strided cotangent
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kw = dict(scale=0.125, causal=causal, kv_lengths=lens, window=window)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    before = LAUNCHES["flash_bwd"]
    got = fa.flash_bwd(q, k, v, o, lse, do, **kw)
    assert LAUNCHES["flash_bwd"] == before + 1
    for g, r in zip(got, fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)):
        _close(g, r, dtype)


@pytest.mark.parametrize("policy", ["lse", "recompute"])
def test_flash_autograd_runs_k1_and_k4(gen, policy):
    q, k, v = (x.detach().requires_grad_() for x in _qkv(gen, 2, 96, 96, torch.float32))
    w = _randn(gen, 2, 96, 4, 64, dtype=torch.float32)
    before = dict(LAUNCHES)
    (fa.flash_attention(q, k, v, causal=True, policy=policy) * w).sum().backward()
    assert LAUNCHES["flash_fwd"] == before["flash_fwd"] + (2 if policy == "recompute" else 1)
    assert LAUNCHES["flash_bwd"] == before["flash_bwd"] + 1
    o, lse = fa.flash_fwd_plain(q, k, v, scale=0.125, causal=True)
    for g, r in zip((q.grad, k.grad, v.grad),
                    fa.flash_bwd_plain(q, k, v, o, lse, w, scale=0.125, causal=True)):
        _close(g, r, torch.float32)


#: exact-probe shapes (``exact_probe``): lq, lk, causal, kv_lengths, window
PROBES = [(100, 100, True, None, None), (16, 130, True, None, None),
          (64, 64, False, [64, 9, 0], None), (200, 200, True, None, 33),
          (96, 160, True, [160, 100, 0], 100)]


def _exact(got, want):
    """Within 1e-6 of an exactly known result (0 for dq and dk)."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-6 * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,causal,lengths,window", PROBES)
def test_flash_fwd_bwd_exact_probe(gen, dtype, lq, lk, causal, lengths, window):
    """One-hot softmax rows with small-integer v and do: the exact answer is
    known, and in half the rows a dead key just past a mask boundary would
    win the softmax if let in. So a live key masked out, a dead key let in,
    or a wrong fragment-to-(row, key) mapping in the row reductions or an
    output store shows as an error far above rounding."""
    p = exact_probe(3, lq, lk, 4, causal=causal, kv_lengths=lengths, window=window, seed=1,
                       dtype=dtype, device="cuda")
    kw = dict(scale=p["scale"], causal=causal, kv_lengths=p["kv_lengths"], window=window)
    o, lse = fa.flash_fwd(p["q"], p["k"], p["v"], **kw)
    _exact(o, p["o"])
    _exact(lse, p["lse"])
    for name, g in zip(("dq", "dk", "dv"), fa.flash_bwd(p["q"], p["k"], p["v"], o, lse, p["do"], **kw)):
        _exact(g, p[name])


# ---------------------------------------------------------------------------
# head dim 128 (the LLaMA family): K1, K4 and K3's own instances
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,causal,lengths,window", [
    (100, 100, True, None, None), (16, 130, True, None, None), (64, 64, False, [64, 9, 0], None),
    (90, 90, True, [90, 40, 1], None), (200, 200, True, None, 33), (130, 130, False, None, None)])
def test_flash_fwd_bwd_match_plain_d128(gen, dtype, lq, lk, causal, lengths, window):
    """K1 and K4 at head dim 128 against their plain versions, q, k and v
    strided slices of one fused tensor where lq == lk, do strided."""
    b, h, d = 3, 4, 128
    if lq == lk:
        qkv = _randn(gen, b, lq, 3, h, d, dtype=dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = (_randn(gen, b, n, h, d, dtype=dtype) for n in (lq, lk, lk))
    do = _randn(gen, b, lq, h, 2, d, dtype=dtype)[:, :, :, 0]
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kw = dict(scale=d**-0.5, causal=causal, kv_lengths=lens, window=window)
    before = dict(LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    got = fa.flash_bwd(q, k, v, o, lse, do, **kw)
    assert LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert LAUNCHES["flash_bwd"] == before["flash_bwd"] + 1
    ro, rlse = fa.flash_fwd_plain(q, k, v, **kw)
    _close(o, ro, dtype)
    _close(lse, rlse, torch.float32)
    for g, r in zip(got, fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)):
        _close(g, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,causal,lengths,window", PROBES + [(300, 300, True, None, 100)])
def test_flash_fwd_bwd_exact_probe_d128(gen, dtype, lq, lk, causal, lengths, window):
    """The exact probe at head dim 128 (keys coded over 128 dims)."""
    p = exact_probe(3, lq, lk, 4, causal=causal, kv_lengths=lengths, window=window, seed=2,
                    dtype=dtype, device="cuda", head_dim=128)
    kw = dict(scale=p["scale"], causal=causal, kv_lengths=p["kv_lengths"], window=window)
    o, lse = fa.flash_fwd(p["q"], p["k"], p["v"], **kw)
    _exact(o, p["o"])
    _exact(lse, p["lse"])
    for name, g in zip(("dq", "dk", "dv"), fa.flash_bwd(p["q"], p["k"], p["v"], o, lse, p["do"], **kw)):
        _exact(g, p[name])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lengths", [(1, [0, 1, 63, 64, 65, 200, 256, 257]),
                                        (16, [0, 1, 15, 16, 100, 256, 272, 5]),
                                        (20, [3, 40, 256, 276])])
def test_flash_decode_matches_plain_d128(gen, dtype, lq, lengths):
    """K3 at head dim 128, both operand forms: values against the plain
    version, int8 codes against the plain version of the dequantised pool
    and bit for bit against the value form on it."""
    s, d = len(lengths), 128
    q = _randn(gen, s, lq, 4, d, dtype=dtype)
    codes = torch.randint(-127, 128, (2, s, 256, 4, d), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
    scales = (torch.rand(2, s, 256, 4, 1, generator=gen, device="cuda") * 0.05 + 1e-3).to(dtype)
    k, v = fa.dequantize_kv(codes[0], scales[0], dtype), fa.dequantize_kv(codes[1], scales[1], dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = LAUNCHES["flash_decode"]
    o = fa.flash_decode(q, k, v, lens)
    o8 = fa.flash_decode(q, codes[0], codes[1], lens, k_scale=scales[0], v_scale=scales[1])
    assert LAUNCHES["flash_decode"] == before + 2
    _close(o, fa.flash_decode_plain(q, k, v, lens, scale=d**-0.5), dtype)
    torch.cuda.synchronize()
    assert torch.equal(o8, o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["values", "int8"])
@pytest.mark.parametrize("lq,lengths", [(1, [0, 1, 64, 65, 129, 255, 256, 257]),
                                        (16, [0, 1, 15, 16, 100, 256, 272, 250])])
def test_flash_decode_exact_probe_d128(dtype, form, lq, lengths):
    """K3's exact probe at head dim 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for half in (lengths[:4], lengths[4:]):
        p = decode_exact_probe(half, lq, 256, 4, seed=lq + 1, dtype=dtype, device="cuda",
                               head_dim=128)
        kw = {} if form == "values" else dict(k_scale=p["k_scale"], v_scale=p["v_scale"])
        k, v = (p["k"], p["v"]) if form == "values" else (p["k_codes"], p["v_codes"])
        o = fa.flash_decode(p["q"], k, v, p["lengths"], scale=p["scale"], **kw)
        torch.cuda.synchronize()
        assert (o.float() - p["o"].float()).abs().max().item() <= 1e-6 * 4


def test_flash_refuses_misaligned_bf16(gen):
    """The bf16 tensor-core bodies load 16-byte rows: a view one element off
    a 16-byte boundary, or with a row stride that is not a multiple of 8,
    raises ValueError naming the tensor instead of being copied."""
    b, l, h = 2, 64, 4
    n = b * l * h * 64
    flat = _randn(gen, n + 1, dtype=torch.bfloat16)
    off = flat[1:].view(b, l, h, 64)  # 2 bytes past the allocation's 16-byte start
    ok = _randn(gen, b, l, h, 64, dtype=torch.bfloat16)
    wide = _randn(gen, b, l, h, 65, dtype=torch.bfloat16)[..., :64]  # strides 65 h, 65
    for bad in (off, wide):
        with pytest.raises(ValueError, match="flash_fwd: bf16 k"):
            fa.flash_fwd(ok, bad, ok, scale=0.125, causal=True)
    o, lse = fa.flash_fwd(ok, ok, ok, scale=0.125, causal=True)
    for bad in (off, wide):
        with pytest.raises(ValueError, match="flash_bwd: bf16 do"):
            fa.flash_bwd(ok, ok, ok, o, lse, bad, scale=0.125, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lengths", [(1, [0, 1, 63, 64, 65, 200, 256, 257]),
                                        (16, [0, 1, 15, 16, 100, 256, 272, 5]),
                                        (20, [3, 40, 256, 276])])
def test_flash_decode_matches_plain(gen, dtype, lq, lengths):
    s = len(lengths)
    q = _randn(gen, s, lq, 4, 64, dtype=dtype)
    k, v = (_randn(gen, s, 256, 4, 64, dtype=dtype) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = LAUNCHES["flash_decode"]
    o = fa.flash_decode(q, k, v, lens)
    assert LAUNCHES["flash_decode"] == before + 1
    _close(o, fa.flash_decode_plain(q, k, v, lens, scale=0.125), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n,groups", [(8, 1024, 3072, 16), (128, 4096, 1024, 64), (5, 96, 40, 3)])
def test_quant_matmul_matches_plain(gen, dtype, bits, m, k, n, groups):
    qmax = 127 if bits == 8 else 7
    codes = torch.randint(-qmax, qmax + 1, (k, n), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
    qw = codes if bits == 8 else pack_rows(codes)
    scale = torch.rand(groups, n, generator=gen, device="cuda") * 0.02 + 1e-3
    x = _randn(gen, m, k, dtype=dtype)
    before = LAUNCHES["quant_matmul"]
    out = qm.quant_matmul(x, qw, scale, bits=bits)
    assert LAUNCHES["quant_matmul"] == before + 1
    _close(out, qm.quant_matmul_plain(x, qw, scale, bits), dtype)


def _quant_operands(gen, m, k, n, groups, bits, dtype):
    qmax = 127 if bits == 8 else 7
    codes = torch.randint(-qmax, qmax + 1, (k, n), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
    qw = codes if bits == 8 else pack_rows(codes)
    scale = torch.rand(groups, n, generator=gen, device="cuda") * 0.02 + 1e-3
    return _randn(gen, m, k, dtype=dtype), qw, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 128, 130])
@pytest.mark.parametrize("k,n,groups", [(1024, 1024, 16), (320, 272, 5), (4096, 1024, 64)])
def test_quant_matmul_bodies_match_plain(gen, dtype, bits, m, k, n, groups):
    """Every body at ragged M, N not a multiple of the decode body's 128 or
    the prefill body's 64 columns, K not a multiple of a split's 64-row
    step times its split count, and the path's K splits."""
    x, qw, scale = _quant_operands(gen, m, k, n, groups, bits, dtype)
    body = qm.qmm_body(m, k, n, k // groups, dtype == torch.bfloat16, True)
    assert body == ("fma" if dtype == torch.float32 else "gemv" if m <= 16 else "mma")
    before = LAUNCHES["quant_matmul"]
    out = qm.quant_matmul(x, qw, scale, bits=bits)
    assert LAUNCHES["quant_matmul"] == before + 1
    _close(out, qm.quant_matmul_plain(x, qw, scale, bits), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("round_scales", [False, True])
def test_quant_matmul_probe_is_exact(dtype, bits, m, round_scales):
    """Inputs on which every summation order gives the same bits: the
    kernel must equal its plain version exactly, so a weight put in the
    wrong (row, column), a wrong group's scale, a wrong nibble or sign, or
    (round_scales, bf16) a weight not rounded to bf16 before the product
    shows as a wrong output."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    p = quant_matmul_probe(m, 1024, 1024, bits, round_scales=round_scales, seed=m + bits,
                           dtype=dtype, device="cuda")
    out = qm.quant_matmul(p["x"], p["qw"], p["scale"], bits=bits)
    ref = qm.quant_matmul_plain(p["x"], p["qw"], p["scale"], bits)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_quant_matmul_odd_shapes_take_the_general_body(gen):
    """bf16 with N or the group size not a multiple of 16 runs the FMA body."""
    for k, n, groups in ((96, 40, 3), (96, 48, 4)):
        x, qw, scale = _quant_operands(gen, 8, k, n, groups, 8, torch.bfloat16)
        assert qm.qmm_body(8, k, n, k // groups, True, True) == "fma"
        _close(qm.quant_matmul(x, qw, scale), qm.quant_matmul_plain(x, qw, scale, 8),
               torch.bfloat16)


def _int8_pool(gen, s, p_len, h, dtype):
    codes = torch.randint(-127, 128, (2, s, p_len, h, 64), generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
    scales = (torch.rand(2, s, p_len, h, 1, generator=gen, device="cuda") * 0.05 + 1e-3).to(dtype)
    return codes[0], codes[1], scales[0], scales[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lengths", [(1, [0, 1, 63, 64, 65, 200, 256, 257]),
                                        (16, [0, 1, 15, 16, 100, 256, 272, 5]),
                                        (1, [256, 0, 0, 0]), (16, [256, 0, 0, 0])])
def test_flash_decode_int8_form(gen, dtype, lq, lengths):
    """The int8 operand form against its plain version (dequantise, then
    flash_decode_plain), and bit for bit against the value form of the
    same kernel on the dequantised pool."""
    s = len(lengths)
    q = _randn(gen, s, lq, 4, 64, dtype=dtype)
    kc, vc, ks, vs = _int8_pool(gen, s, 256, 4, dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = LAUNCHES["flash_decode"]
    o = fa.flash_decode(q, kc, vc, lens, k_scale=ks, v_scale=vs)
    assert LAUNCHES["flash_decode"] == before + 1
    _close(o, fa.flash_decode_plain(q, kc, vc, lens, scale=0.125, k_scale=ks, v_scale=vs), dtype)
    k, v = fa.dequantize_kv(kc, ks, dtype), fa.dequantize_kv(vc, vs, dtype)
    o_values = fa.flash_decode(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(o, o_values)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["values", "int8"])
@pytest.mark.parametrize("lq,lengths", [(1, [0, 1, 64, 65, 129, 255, 256, 257]),
                                        (16, [0, 1, 15, 16, 100, 256, 272, 250])])
def test_flash_decode_exact_probe(dtype, form, lq, lengths):
    """One-hot softmax rows with a dead decoy just past each live range (or
    in the next slot, past a full pool) that would win if read: o within
    1e-6 of v's picked row, 0 where no key is live."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for half in (lengths[:4], lengths[4:]):
        p = decode_exact_probe(half, lq, 256, 4, seed=lq, dtype=dtype, device="cuda")
        kw = {} if form == "values" else dict(k_scale=p["k_scale"], v_scale=p["v_scale"])
        k, v = (p["k"], p["v"]) if form == "values" else (p["k_codes"], p["v_codes"])
        o = fa.flash_decode(p["q"], k, v, p["lengths"], scale=p["scale"], **kw)
        torch.cuda.synchronize()
        assert (o.float() - p["o"].float()).abs().max().item() <= 1e-6 * 4


def test_flash_decode_refuses_what_the_kernel_does_not_take(gen):
    q = _randn(gen, 2, 1, 4, 64, dtype=torch.bfloat16)
    kc, vc, ks, vs = _int8_pool(gen, 2, 64, 4, torch.bfloat16)
    lens = torch.tensor([3, 64], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        fa.flash_decode(q, kc, vc, lens, k_scale=ks)
    with pytest.raises(ValueError, match="must be torch.int8"):
        fa.flash_decode(q, kc.to(torch.bfloat16), vc, lens, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="k_scale must be"):
        fa.flash_decode(q, kc, vc, lens, k_scale=ks.float(), v_scale=vs)
    wide = torch.zeros(2, 64, 4, 72, dtype=torch.int8, device="cuda")[..., 4:68]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_decode(q, wide, vc, lens, k_scale=ks, v_scale=vs)


def test_flash_backend_raises_on_cuda_for_bias(gen):
    q = _randn(gen, 1, 8, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, bias=torch.zeros(1, 4, 8, 8, device="cuda"))


def _injective_idx(gen, groups, n, r):
    """[G, r] int32 on the card: unique entries below n per group, about a
    quarter replaced by the sentinel n + 7."""
    idx = torch.stack([torch.randperm(max(n, r), generator=gen, device="cuda")[:r]
                       for _ in range(groups)])
    drop = torch.rand(idx.shape, generator=gen, device="cuda") < 0.25
    return torch.where(drop | (idx >= n), n + 7, idx).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups,n,m,r", [(1, 8192, 1024, 10240), (1, 10240, 1024, 8192),
                                          (2, 12, 8, 20), (4, 6, 128, 4), (2, 7, 3, 9)])
def test_moe_permute_matches_plain(gen, dtype, groups, n, m, r):
    x = _randn(gen, groups, n, m, dtype=dtype)
    idx = _injective_idx(gen, groups, n, r)
    before = LAUNCHES["moe_permute"]
    out = md.moe_permute(x, idx)
    assert LAUNCHES["moe_permute"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, md.moe_permute_plain(x, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_permute_rows_autograd_runs_k5_both_ways(gen, dtype):
    x = _randn(gen, 2, 40, 64, dtype=dtype).requires_grad_()
    fwd = _injective_idx(gen, 2, 40, 50)
    bwd = md.inverse_index(fwd, 40)
    cot = _randn(gen, 2, 64, 50, dtype=dtype).transpose(1, 2)  # strided cotangent
    before = LAUNCHES["moe_permute"]
    out = md.permute_rows(x, fwd, bwd, impl="pallas")
    (gx,) = torch.autograd.grad(out, x, cot)
    assert LAUNCHES["moe_permute"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(out, md.moe_permute_plain(x, fwd))
    x_plain = x.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(md.permute_rows(x_plain, fwd, bwd, impl="xla"), x_plain, cot)
    assert torch.equal(gx, want)


def test_moe_permute_refuses_what_the_kernel_does_not_take(gen):
    x = _randn(gen, 1, 8, 16, dtype=torch.float32)
    with pytest.raises(ValueError, match="int32"):
        md.moe_permute(x, torch.zeros(1, 4, dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        md.moe_permute(x.half(), torch.zeros(1, 4, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="one CUDA device"):
        md.moe_permute(x, torch.zeros(1, 4, dtype=torch.int32))


def test_moe_layer_on_the_card_matches_the_cpu(gen):
    """A GPT-2-MLP MoE layer (top-1, no RTS) in fp32: output and gradients on
    the card (K5 twice forward, twice backward) against the CPU's plain
    versions, within 1e-4 of the largest magnitude."""
    from deepspeed_tpu_torch.models.gpt2 import MLP, get_gpt2_config
    from deepspeed_tpu_torch.moe import MOELayer

    cfg = get_gpt2_config("test", n_embd=64, n_head=4)
    layers = {dev: MOELayer(MLP(cfg, dev), 64, 4, capacity_factor=1.0, min_capacity=1,
                            use_rts=False) for dev in ("cuda", "cpu")}
    with torch.no_grad():
        for p in layers["cuda"].parameters():
            p.normal_(0.0, 0.1, generator=gen)
    layers["cpu"].load_state_dict({k: v.cpu() for k, v in layers["cuda"].state_dict().items()})
    x = _randn(gen, 2, 48, 64, dtype=torch.float32)
    before = LAUNCHES["moe_permute"]
    grads = {}
    for dev, layer in layers.items():
        xd = x.detach().to(dev, copy=True).requires_grad_()
        out, l_aux, _ = layer(xd, deterministic=False)
        ((out**2).sum() + l_aux).backward()
        grads[dev] = [out.detach(), xd.grad] + [p.grad for p in layer.parameters()]
    assert LAUNCHES["moe_permute"] == before + 4
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        _close(got.cpu(), ref, torch.float32)


def _sparse_layout(seed, h, n):
    """Per-head random layouts over n blocks that keep most diagonals and
    hold the edge cases: query block 1 attends nothing (an empty row),
    query block 2 only the last block (above the diagonal: empty under
    causal), and key block n - 2 is read by no query block."""
    rng = np.random.default_rng(seed)
    layout = (rng.random((h, n, n)) < 0.35).astype(np.int64)
    layout[:, np.arange(n), np.arange(n)] = 1
    layout[:, 1, :] = 0
    layout[:, 2, :] = 0
    layout[:, 2, n - 1] = 1
    layout[:, :, n - 2] = 0
    return layout


def _sparse_inputs(gen, b, l, h, dtype):
    qkv = _randn(gen, b, l, 3, h, 64, dtype=dtype)  # strided q, k, v, as the model gives them
    do = _randn(gen, b, l, h, 2, 64, dtype=dtype)[:, :, :, 0]  # strided cotangent
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_sparse_fwd_bwd_match_plain(gen, dtype, block, causal):
    b, h, n = 2, 3, 8
    l = n * block
    kidx, kcnt, qidx, qcnt = index_lists_on(_sparse_layout(block, h, n), "cuda")
    q, k, v, do = _sparse_inputs(gen, b, l, h, dtype)
    kw = dict(scale=0.125, causal=causal, block=block)
    before = dict(LAUNCHES)
    o, lse = sa.sparse_fwd(q, k, v, kidx, kcnt, **kw)
    got = sa.sparse_bwd(q, k, v, o, lse, do, kidx, kcnt, qidx, qcnt, **kw)
    assert LAUNCHES["sparse_fwd"] == before["sparse_fwd"] + 1
    assert LAUNCHES["sparse_bwd"] == before["sparse_bwd"] + 1
    ro, rlse = sa.sparse_fwd_plain(q, k, v, kidx, kcnt, **kw)
    _close(o, ro, dtype)
    live = rlse > -1e30
    assert torch.equal(live, lse > -1e30)
    assert not live[:, :, block:2 * block].any()  # the empty row
    above = live[:, :, 2 * block:3 * block]  # only a block above the diagonal
    assert bool(above.all()) if not causal else not above.any()
    _close(lse[live], rlse[live], torch.float32)
    for g, r in zip(got, sa.sparse_bwd_plain(q, k, v, o, lse, do, kidx, kcnt, qidx, qcnt, **kw)):
        _close(g, r, dtype)
    dead = slice((n - 2) * block, (n - 1) * block)
    assert (got[1][:, dead] == 0).all() and (got[2][:, dead] == 0).all()


@pytest.mark.parametrize("block", [16, 64])
def test_sparse_nan_probe_on_the_card(gen, block):
    """NaNs in the K/V rows of a key block no query block reads: o, dq, dk
    and dv stay finite, and dk = dv = 0 there."""
    b, h, n = 1, 2, 6
    l = n * block
    kidx, kcnt, qidx, qcnt = index_lists_on(_sparse_layout(7, h, n), "cuda")
    q, k, v, do = (x.contiguous() for x in _sparse_inputs(gen, b, l, h, torch.float32))
    dead = slice((n - 2) * block, (n - 1) * block)
    k[:, dead] = float("nan")
    v[:, dead] = float("nan")
    kw = dict(scale=0.125, causal=False, block=block)
    o, lse = sa.sparse_fwd(q, k, v, kidx, kcnt, **kw)
    dq, dk, dv = sa.sparse_bwd(q, k, v, o, lse, do, kidx, kcnt, qidx, qcnt, **kw)
    torch.cuda.synchronize()
    for x in (o, dq, dk, dv):
        assert torch.isfinite(x).all()
    assert (dk[:, dead] == 0).all() and (dv[:, dead] == 0).all()
    _close(o, sa.sparse_fwd_plain(q, k, v, kidx, kcnt, **kw)[0], torch.float32)


def test_sparse_self_attention_runs_k6_once_each_way(gen):
    from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                          SparseSelfAttention)
    attn = SparseSelfAttention(BigBirdSparsityConfig(num_heads=4, block=32, num_random_blocks=2,
                                                     different_layout_per_head=True, seed=3))
    q, k, v = (_randn(gen, 2, 256, 4, 64, dtype=torch.float32).requires_grad_() for _ in range(3))
    w = _randn(gen, 2, 256, 4, 64, dtype=torch.float32)
    before = dict(LAUNCHES)
    (attn(q, k, v) * w).sum().backward()
    assert LAUNCHES["sparse_fwd"] == before["sparse_fwd"] + 1
    assert LAUNCHES["sparse_bwd"] == before["sparse_bwd"] + 1
    lists = attn.get_index_lists(256, "cuda")
    assert list(attn._index_lists) == [(256, q.device)]  # built once, "cuda" and "cuda:0" alike
    assert lists is attn.get_index_lists(256, q.device)
    kw = dict(scale=0.125, causal=False, block=32)
    with torch.no_grad():
        o, lse = sa.sparse_fwd_plain(q, k, v, *lists[:2], **kw)
        ref = sa.sparse_bwd_plain(q, k, v, o, lse, w, *lists, **kw)
    for g, r in zip((q.grad, k.grad, v.grad), ref):
        _close(g, r, torch.float32)


def test_sparse_refuses_what_the_kernel_does_not_take(gen):
    kidx, kcnt, _, _ = index_lists_on(np.ones((2, 4, 4), np.int64), "cuda")
    q = _randn(gen, 1, 64, 2, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        sa.sparse_fwd(q[..., :32], q[..., :32], q[..., :32], kidx, kcnt, scale=1.0, causal=False,
                      block=16)
    with pytest.raises(ValueError, match="layout block"):
        lists = index_lists_on(np.ones((2, 8, 8), np.int64), "cuda")
        sa.sparse_fwd(q, q, q, *lists[:2], scale=1.0, causal=False, block=8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sa.sparse_fwd(q.half(), q.half(), q.half(), kidx, kcnt, scale=1.0, causal=False, block=16)
    with pytest.raises(ValueError, match="int32"):
        sa.sparse_fwd(q, q, q, kidx.long(), kcnt, scale=1.0, causal=False, block=16)
    with pytest.raises(ValueError, match="multiple"):
        sa.sparse_fwd(q[:, :60], q[:, :60], q[:, :60], kidx, kcnt, scale=1.0, causal=False, block=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,l", [(16, 256), (64, 512), (16, 80), (32, 96)])
@pytest.mark.parametrize("causal", [False, True])
def test_sparse_exact_probe(gen, dtype, block, l, causal):
    """K6 on one-hot rows over a random per-head layout, half of them with a
    dead decoy (in a block the layout leaves out, or past the diagonal) that
    would win if let in: o, lse, dq, dk and dv within 1e-6 of the exact
    answer, in the longest-first launch order. At 80 and 96 rows the last
    thread block holds fewer list groups than it has room for."""
    p = sparse_exact_probe(2, l, 3, block, causal=causal, seed=1, dtype=dtype, device="cuda")
    lists = index_lists_on(p["layout"], "cuda")
    q_order, k_order = launch_orders_on(p["layout"], block, "cuda")
    kw = dict(scale=p["scale"], causal=causal, block=block)
    o, lse = sa.sparse_fwd(p["q"], p["k"], p["v"], *lists[:2], order=q_order, **kw)
    _exact(o, p["o"])
    _exact(lse, p["lse"])
    grads = sa.sparse_bwd(p["q"], p["k"], p["v"], o, lse, p["do"], *lists, q_order=q_order,
                          k_order=k_order, **kw)
    for name, g in zip(("dq", "dk", "dv"), grads):
        _exact(g, p[name])


@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_sparse_launch_order_leaves_the_result_as_it_is(gen, block):
    """Each output tile has one owner whatever the order the tiles run in:
    the longest-first order gives the natural order's result bit for bit."""
    b, h, n = 2, 3, 8
    l = n * block
    layout = _sparse_layout(block + 1, h, n)
    lists = index_lists_on(layout, "cuda")
    q_order, k_order = launch_orders_on(layout, block, "cuda")
    q, k, v, do = _sparse_inputs(gen, b, l, h, torch.bfloat16)
    kw = dict(scale=0.125, causal=True, block=block)
    o, lse = sa.sparse_fwd(q, k, v, *lists[:2], **kw)
    o2, lse2 = sa.sparse_fwd(q, k, v, *lists[:2], order=q_order, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    got = sa.sparse_bwd(q, k, v, o, lse, do, *lists, **kw)
    got2 = sa.sparse_bwd(q, k, v, o, lse, do, *lists, q_order=q_order, k_order=k_order, **kw)
    for g, g2 in zip(got, got2):
        assert torch.equal(g, g2)


def test_sparse_refuses_misaligned_bf16(gen):
    """The bf16 tensor-core bodies load 16-byte rows: a view one element off
    a 16-byte boundary, or with a row stride that is not a multiple of 8,
    raises ValueError naming the tensor instead of being copied."""
    b, l, h = 1, 64, 2
    lists = index_lists_on(np.ones((h, 4, 4), np.int64), "cuda")
    flat = _randn(gen, b * l * h * 64 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(b, l, h, 64)  # 2 bytes past the allocation's 16-byte start
    ok = _randn(gen, b, l, h, 64, dtype=torch.bfloat16)
    wide = _randn(gen, b, l, h, 65, dtype=torch.bfloat16)[..., :64]  # strides 65 h, 65
    kw = dict(scale=0.125, causal=False, block=16)
    for bad in (off, wide):
        with pytest.raises(ValueError, match="sparse_fwd: bf16 v"):
            sa.sparse_fwd(ok, ok, bad, *lists[:2], **kw)
    o, lse = sa.sparse_fwd(ok, ok, ok, *lists[:2], **kw)
    for bad in (off, wide):
        with pytest.raises(ValueError, match="sparse_bwd: bf16 do"):
            sa.sparse_bwd(ok, ok, ok, o, lse, bad, *lists, **kw)
    with pytest.raises(ValueError, match="launch order"):
        sa.sparse_fwd(ok, ok, ok, *lists[:2], order=lists[1].flatten()[:3], **kw)
