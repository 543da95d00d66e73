"""The exact probe of K6 (``deepspeed_tpu_torch.testing.sparse_exact_probe``)
on the CPU: K6's plain versions, which the card tests hold the kernels to,
give the probe's known o, lse, dq, dk and dv exactly, in fp32 and bf16, at
blocks 16 and 64, causal and not; JAX's ``sparse_attention`` (its Pallas
kernels in interpret mode) gives them exactly too, since no probe layout
leaves a query block above the diagonal only; and letting one dead key in,
or masking one live key out, changes o by a whole row of v."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu.ops.sparse_attention as jax_sparse
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import index_lists_on
from deepspeed_tpu_torch.testing import sparse_exact_probe


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: block, length (the card tests and chip_smoke.py probe the same blocks)
SHAPES = [(16, 128), (64, 256)]


def _probe(block, l, causal, dtype):
    return sparse_exact_probe(2, l, 2, block, causal=causal, seed=3, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block,l", SHAPES)
def test_sparse_probe_is_exact_on_the_plain_versions(block, l, causal, dtype):
    p = _probe(block, l, causal, dtype)
    lists = index_lists_on(p["layout"], "cpu")
    kw = dict(scale=p["scale"], causal=causal, block=block)
    o, lse = sa.sparse_fwd(p["q"], p["k"], p["v"], *lists[:2], **kw)
    assert o.dtype == dtype and torch.equal(o, p["o"])
    assert torch.equal(lse, p["lse"])
    grads = sa.sparse_bwd(p["q"], p["k"], p["v"], o, lse, p["do"], *lists, **kw)
    for name, g in zip(("dq", "dk", "dv"), grads):
        assert torch.equal(g, p[name]), name
    # the probe exercises what it is for: one-hot rows that are not all the
    # same key, decoys in dead blocks, and under causal past the diagonal
    assert p["dv"].abs().sum() > 0 and len(torch.unique(p["o"][..., 0])) > 1
    kinds = set(np.unique(p["decoy_kind"]).tolist())
    assert kinds == ({0, 1, 2} if causal else {0, 1})


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block,l", SHAPES)
def test_sparse_probe_is_exact_on_the_jax_kernels(block, l, causal):
    p = _probe(block, l, causal, torch.float32)
    args = [jnp.asarray(p[x].numpy()) for x in ("q", "k", "v")]

    def fn(q, k, v):
        return jax_sparse.sparse_attention(q, k, v, p["layout"], block, causal=causal,
                                           scale=p["scale"])

    o, vjp = jax.vjp(fn, *args)
    np.testing.assert_array_equal(np.asarray(o), p["o"].numpy())
    for name, g in zip(("dq", "dk", "dv"), vjp(jnp.asarray(p["do"].numpy()))):
        np.testing.assert_array_equal(np.asarray(g), p[name].numpy(), err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block,l", SHAPES)
def test_sparse_probe_catches_one_key_off(block, l, causal):
    """Each decoy row's o turns into another row of v when its decoy is let
    in, and each row's when its pick is masked out."""
    p = _probe(block, l, causal, torch.float32)
    b, h = 2, 2
    valid = torch.from_numpy(p["layout"].astype(bool)).repeat_interleave(block, 1)
    valid = valid.repeat_interleave(block, 2)[None].expand(b, h, l, l)
    if causal:
        valid = valid & torch.ones(l, l, dtype=torch.bool).tril()
    s = torch.einsum("bqhd,bkhd->bhqk", p["q"] * p["scale"], p["k"])
    key = torch.arange(l)
    decoy = torch.from_numpy(p["decoy"]).permute(0, 2, 1)[..., None]  # [b, h, l, 1]
    pick = torch.from_numpy(p["pick"]).permute(0, 2, 1)[..., None]
    o, _, _ = fa._masked_softmax_av(s, valid, p["v"])
    assert torch.equal(o.transpose(1, 2), p["o"])
    for mask, rows in ((valid | (key == decoy), decoy[..., 0] >= 0),
                       (valid & (key != pick), pick[..., 0] >= 0)):
        o, _, _ = fa._masked_softmax_av(s, mask, p["v"])
        err = (o - p["o"].transpose(1, 2)).abs().amax(-1)  # [b, h, l]
        assert rows.any() and (err[rows] >= 0.5).all()
