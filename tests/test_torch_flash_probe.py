"""The exact probe of K1 and K4 (``deepspeed_tpu_torch.testing.exact_probe``)
on the CPU: the plain versions, which the card tests hold the kernels to,
give the probe's known answer exactly, in fp32 and bf16, at the shapes the
card tests probe (a ragged length, lq < lk, kv_lengths with a 0, windows);
and a mask that lets in one dead key past a boundary, or drops one live
key, changes o by far more than rounding."""

import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.testing import exact_probe


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: lq, lk, causal, kv_lengths, window (the same list as the card tests')
PROBES = [(100, 100, True, None, None), (16, 130, True, None, None),
          (64, 64, False, [64, 9, 0], None), (200, 200, True, None, 33),
          (96, 160, True, [160, 100, 0], 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,causal,lengths,window", PROBES)
def test_exact_probe_is_exact_on_the_plain_versions(dtype, lq, lk, causal, lengths, window):
    p = exact_probe(3, lq, lk, 4, causal=causal, kv_lengths=lengths, window=window, seed=1,
                    dtype=dtype)
    kw = dict(scale=p["scale"], causal=causal, kv_lengths=p["kv_lengths"], window=window)
    o, lse = fa.flash_fwd(p["q"], p["k"], p["v"], **kw)
    assert o.dtype == dtype and torch.equal(o, p["o"])
    assert torch.equal(lse, p["lse"])
    grads = fa.flash_bwd(p["q"], p["k"], p["v"], o, lse, p["do"], **kw)
    for name, g in zip(("dq", "dk", "dv"), grads):
        assert torch.equal(g, p[name]), name
    # the probe exercises what it is for: dead rows where asked, one-hot
    # rows that are not all the same key, and decoys past every boundary
    live = p["lse"] > 0
    assert live.any() and (lengths is None or not live.all())
    assert p["dv"].abs().sum() > 0 and len(torch.unique(p["o"][..., 0])) > 1
    has_d = (p["decoy"] >= 0) & (p["pick"] >= 0)
    above, below = has_d & (p["decoy"] > p["pick"]), has_d & (p["decoy"] < p["pick"])
    assert above.any() == (causal or lengths is not None)
    assert below.any() == (window is not None)


@pytest.mark.parametrize("lq,lk,causal,lengths,window", PROBES)
def test_exact_probe_catches_one_key_off(lq, lk, causal, lengths, window):
    """Each decoy row's o turns into another row of v when its decoy is let
    in, and each live row's when its pick is masked out."""
    p = exact_probe(3, lq, lk, 4, causal=causal, kv_lengths=lengths, window=window, seed=1,
                    dtype=torch.float32)
    lens = p["kv_lengths"]
    valid = fa.live_pairs(lq, lk, causal, lens, window, "cpu").expand(3, 4, lq, lk)
    s = torch.einsum("bqhd,bkhd->bhqk", p["q"] * p["scale"], p["k"])
    key = torch.arange(lk)
    decoy = torch.from_numpy(p["decoy"]).permute(0, 2, 1)[..., None]  # [b, h, lq, 1]
    pick = torch.from_numpy(p["pick"]).permute(0, 2, 1)[..., None]
    for mask, rows in ((valid | (key == decoy), decoy[..., 0] >= 0),
                       (valid & (key != pick), pick[..., 0] >= 0)):
        o, _, _ = fa._masked_softmax_av(s, mask, p["v"])
        err = (o - p["o"].transpose(1, 2)).abs().amax(-1)  # [b, h, lq]
        assert rows.any() and (err[rows] >= 0.5).all()
