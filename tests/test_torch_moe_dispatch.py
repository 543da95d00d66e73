"""The port's row permutation (``ops/cuda/moe_dispatch.py``, K5's plain
version on the CPU) against the JAX package's ``ops/pallas/moe_dispatch``:
``permute_rows`` with ``impl="xla"`` and ``impl="pallas"`` (the JAX Pallas
kernel in interpret mode) on the cases of
``tests/unit/ops/test_moe_dispatch.py``, its gradient, ``inverse_index``,
sentinel rows, bf16 and ``resolve_impl``. A gather copies values, so
forward results and gradients must be equal exactly (tolerance 0).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas import moe_dispatch as jax_md
from deepspeed_tpu_torch.ops.cuda import LAUNCHES, reset_launches
from deepspeed_tpu_torch.ops.cuda import moe_dispatch as md


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_injective_idx(rng, groups, n, r):
    """[G, r] int32: unique in-range entries per group, ~1/4 sentinel (the
    JAX test's helper)."""
    idx = np.stack([rng.permutation(max(n, r))[:r] for _ in range(groups)])
    drop = rng.random(idx.shape) < 0.25
    return np.where(drop | (idx >= n), n + 7, idx).astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("groups,n,r", [(3, 12, 8), (1, 8, 8), (2, 12, 20), (4, 6, 4)])
def test_inverse_index_matches_jax(groups, n, r):
    fwd = _random_injective_idx(np.random.default_rng(0), groups, n, r)
    want = np.asarray(jax_md.inverse_index(jnp.asarray(fwd), n))
    got = md.inverse_index(torch.from_numpy(fwd), n)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("groups,n,m,r", [(1, 8, 16, 8), (2, 12, 8, 20), (4, 6, 128, 4)])
def test_permute_rows_and_gradient_match_jax(impl, groups, n, m, r):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(groups, n, m)).astype(np.float32)
    fwd = _random_injective_idx(rng, groups, n, r)
    bwd = np.array(jax_md.inverse_index(jnp.asarray(fwd), n))
    cot = rng.normal(size=(groups, r, m)).astype(np.float32)

    def jax_loss(kernel_impl):
        return lambda xx: (jax_md.permute_rows(xx, jnp.asarray(fwd), jnp.asarray(bwd),
                                               impl=kernel_impl, interpret=True)
                           * jnp.asarray(cot)).sum()

    want = {i: np.asarray(jax_md.permute_rows(jnp.asarray(x), jnp.asarray(fwd), jnp.asarray(bwd),
                                              impl=i, interpret=True)) for i in ("xla", "pallas")}
    want_grad = {i: np.asarray(jax.grad(jax_loss(i))(jnp.asarray(x))) for i in ("xla", "pallas")}

    reset_launches()
    xt = torch.from_numpy(x).requires_grad_()
    out = md.permute_rows(xt, torch.from_numpy(fwd), torch.from_numpy(bwd), impl=impl)
    (out * torch.from_numpy(cot)).sum().backward()
    for i in ("xla", "pallas"):
        np.testing.assert_array_equal(_np(out), want[i])
        np.testing.assert_array_equal(_np(xt.grad), want_grad[i])
    dead = fwd >= n
    assert np.all(_np(out)[dead] == 0)
    assert LAUNCHES["moe_permute"] == 0  # CPU tensors: the plain version, no launch


def test_pallas_impl_backward_is_the_inverse_gather():
    """``impl="pallas"``'s backward is a second gather by ``bwd_idx`` (no
    scatter-add): a non-contiguous cotangent gives the same gradient."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 10, 6)).astype(np.float32)).requires_grad_()
    fwd = torch.from_numpy(_random_injective_idx(rng, 2, 10, 16))
    bwd = md.inverse_index(fwd, 10)
    cot = torch.from_numpy(rng.normal(size=(2, 6, 16)).astype(np.float32)).transpose(1, 2)
    assert not cot.is_contiguous()
    out = md.permute_rows(x, fwd, bwd, impl="pallas")
    (gx,) = torch.autograd.grad(out, x, cot)
    torch.testing.assert_close(gx, md.moe_permute_plain(cot.contiguous(), bwd), rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_permute_rows_bf16_matches_jax(impl):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    fwd = _random_injective_idx(rng, 2, 8, 8)
    bwd = np.array(jax_md.inverse_index(jnp.asarray(fwd), 8))
    want = jax_md.permute_rows(jnp.asarray(x, jnp.bfloat16), jnp.asarray(fwd), jnp.asarray(bwd),
                               impl="pallas", interpret=True)
    got = md.permute_rows(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(fwd),
                          torch.from_numpy(bwd), impl=impl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_sentinel_rows_are_exact_zeros_at_the_slice_geometry():
    """The dispatch and combine maps of one routed group: S token copies
    into E*C slots and back, with a quarter of the copies dropped."""
    rng = np.random.default_rng(3)
    s, e, c, m = 64, 4, 20, 16
    slots = rng.permutation(e * c)[:s]
    slots[rng.random(s) < 0.25] = e * c  # dropped copies park on the sentinel
    flat_slot = torch.from_numpy(slots[None].astype(np.int32))
    src = md.inverse_index(flat_slot, e * c)
    tokens = torch.from_numpy(rng.normal(size=(1, s, m)).astype(np.float32)) + 5.0
    buf = md.permute_rows(tokens, src, flat_slot, impl="pallas")
    empty = (src[0] >= s).numpy()
    assert empty.sum() == e * c - (slots < e * c).sum()
    assert torch.count_nonzero(buf[0, torch.from_numpy(empty)]) == 0
    back = md.permute_rows(buf, flat_slot, src, impl="pallas")
    kept = torch.from_numpy(slots < e * c)
    torch.testing.assert_close(back[0, kept], tokens[0, kept], rtol=0, atol=0)
    assert torch.count_nonzero(back[0, ~kept]) == 0


def test_resolve_impl():
    assert md.resolve_impl("xla") == "xla"
    assert md.resolve_impl("pallas") == "pallas"
    assert md.resolve_impl("auto") == "pallas"  # K5 on the card
    with pytest.raises(ValueError, match="impl"):
        md.resolve_impl("cuda")
    with pytest.raises(ValueError, match="impl"):
        md.permute_rows(torch.zeros(1, 2, 2), torch.zeros(1, 2, dtype=torch.int32),
                        torch.zeros(1, 2, dtype=torch.int32), impl="triton")


def test_moe_permute_checks_shapes():
    with pytest.raises(ValueError, match=r"\[G, N, M\]"):
        md.moe_permute(torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="integer"):
        md.moe_permute(torch.zeros(1, 2, 3), torch.zeros(1, 2))
