"""The fp16 instances of K1, K4 and K5 against their plain PyTorch versions,
on the GPU (they skip elsewhere, deciding in a fixture).

Tolerances, as max |err| / max |ref|: K1's O within 2e-3 (its p rides an
fp16 hi + lo pair within 2^-25 of p, under O's own fp16 rounding of 2^-11,
``csrc/flash_fwd.cu``), K4's dq, dk and dv within 5e-3 (p and the
power-of-two-scaled ds are rounded to fp16's 11 bits before their second
products, ``csrc/flash_bwd.cu``), lse within 1e-4; K5, a gather, equal. The
overflow probe gives K4 a ds that passes fp16's 65504 (a loss-scaled dO)
where every output stays finite: the kernel must agree with the fp32-math
plain version there instead of turning the gradients to inf. K2, K3 and K6
refuse fp16 by name (ROADMAP.md Queue B item 3).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import LAUNCHES
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda import moe_dispatch as md
from deepspeed_tpu_torch.ops.cuda import quant_matmul as qm
from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import index_lists_on


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.cuda

TOL_O, TOL_GRAD, TOL_LSE = 2e-3, 5e-3, 1e-4


@pytest.fixture
def rng():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return np.random.default_rng(0)


def _half(rng, *shape, std=1.0):
    return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32)).half().cuda()


def _close(got, ref, tol):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * max(ref.float().abs().max().item(), 1e-30), err


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("lq,lk,causal,lengths,window", [
    (100, 100, True, None, None), (16, 130, True, None, None), (64, 64, False, [64, 9, 0], None),
    (200, 200, True, None, 33)])
def test_fp16_flash_fwd_bwd_match_plain(rng, d, lq, lk, causal, lengths, window):
    b, h = 3, 4
    q, k, v = _half(rng, b, lq, h, d), _half(rng, b, lk, h, d), _half(rng, b, lk, h, d)
    do = _half(rng, b, lq, h, d)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kw = dict(scale=d ** -0.5, causal=causal, kv_lengths=lens, window=window)
    before = dict(LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    got = fa.flash_bwd(q, k, v, o, lse, do, **kw)
    assert LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert LAUNCHES["flash_bwd"] == before["flash_bwd"] + 1
    assert o.dtype == torch.float16 and all(g.dtype == torch.float16 for g in got)
    ro, rlse = fa.flash_fwd_plain(q, k, v, **kw)
    _close(o, ro, TOL_O)
    _close(lse, rlse, TOL_LSE)
    for g, r in zip(got, fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)):
        _close(g, r, TOL_GRAD)


def test_fp16_flash_bwd_keeps_a_large_ds_finite(rng):
    """A ds past 65504 with every gradient inside fp16's range: near-uniform
    attention (small q, k), a wide v and a loss-scaled dO."""
    b, l, h, d = 2, 64, 4, 64
    q, k = _half(rng, b, l, h, d, std=0.05), _half(rng, b, l, h, d, std=0.05)
    v, do = _half(rng, b, l, h, d, std=8.0), _half(rng, b, l, h, d, std=1e4)
    kw = dict(scale=0.125, causal=True)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ref = fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * 0.125, k.float())
    p = torch.exp(s - lse[..., None]) * fa.live_pairs(l, l, True, None, None, "cuda")
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None])
    assert ds.abs().max().item() > 65504.0  # the probe's premise
    assert all(torch.isfinite(r).all() for r in ref)
    for g, r in zip(fa.flash_bwd(q, k, v, o, lse, do, **kw), ref):
        _close(g, r, TOL_GRAD)


def test_fp16_flash_autograd_runs_k1_and_k4(rng):
    q, k, v = (_half(rng, 2, 96, 4, 64).requires_grad_() for _ in range(3))
    w = _half(rng, 2, 96, 4, 64)
    before = dict(LAUNCHES)
    (fa.flash_attention(q, k, v, causal=True) * w).float().sum().backward()
    assert LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert LAUNCHES["flash_bwd"] == before["flash_bwd"] + 1
    o, lse = fa.flash_fwd_plain(q, k, v, scale=0.125, causal=True)
    for g, r in zip((q.grad, k.grad, v.grad),
                    fa.flash_bwd_plain(q, k, v, o, lse, w, scale=0.125, causal=True)):
        _close(g, r, TOL_GRAD)


@pytest.mark.parametrize("groups,n,m,r", [(1, 100, 64, 130), (2, 33, 100, 17), (1, 8, 1024, 8)])
def test_fp16_moe_permute_is_exact_both_ways(rng, groups, n, m, r):
    x = _half(rng, groups, n, m).requires_grad_()
    fwd = torch.from_numpy(rng.permutation(max(n, r) + 3)[:r].astype(np.int32)).cuda()
    fwd = fwd.expand(groups, r).contiguous()
    bwd = md.inverse_index(fwd, n)
    before = LAUNCHES["moe_permute"]
    out = md.permute_rows(x, fwd, bwd, impl="pallas")
    g = _half(rng, groups, r, m)
    out.backward(g)
    assert LAUNCHES["moe_permute"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(out, md.moe_permute_plain(x.detach(), fwd))
    assert torch.equal(x.grad, md.moe_permute_plain(g, bwd))


def test_fp16_refused_by_k2_k3_k6_by_name(rng):
    x = _half(rng, 4, 64)
    codes = torch.zeros(64, 64, dtype=torch.int8, device="cuda")
    scales = torch.ones(1, 64, dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="Queue B item 3"):
        qm.quant_matmul(x, codes, scales, bits=8)
    q = _half(rng, 2, 1, 4, 64)
    cache = _half(rng, 2, 64, 4, 64)
    with pytest.raises(ValueError, match="Queue B item 3"):
        fa.flash_decode(q, cache, cache, torch.tensor([3, 64], dtype=torch.int32, device="cuda"))
    kidx, kcnt, _, _ = index_lists_on(np.ones((2, 4, 4), np.int64), "cuda")
    qs = _half(rng, 1, 64, 2, 64)
    with pytest.raises(ValueError, match="Queue B item 3"):
        sa.sparse_fwd(qs, qs, qs, kidx, kcnt, scale=1.0, causal=False, block=16)
