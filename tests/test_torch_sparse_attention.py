"""The port's block-sparse attention (``deepspeed_tpu_torch/ops/
sparse_attention``, K6's plain versions through the ``SparseAttention``
autograd Function) against the JAX package's.

The same seeded numpy inputs go through both: the six sparsity configs'
layouts must equal JAX's bit for bit (the same draws for the same ``seed``)
and raise the same exception types on bad arguments; the index lists must
be equal; outputs within 1e-5 and q/k/v gradients within 1e-4 of JAX's
Pallas kernels run in interpret mode (fp32 on both sides: the sums run in
another order, nothing else differs). One difference is pinned: under
``causal`` the port skips key blocks wholly above the diagonal, so a query
block whose every active block lies above it gives zeros, as the JAX
package's own test states the contract (``_dense_reference``), where the
JAX kernel returns the mean of V over those blocks.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu.ops.sparse_attention as jax_sparse
import deepspeed_tpu_torch.ops.sparse_attention as port_sparse
from deepspeed_tpu_torch.ops.cuda import LAUNCHES
from deepspeed_tpu_torch.ops.cuda import flash_attention as port_flash
from deepspeed_tpu_torch.ops.cuda import sparse_attention as port_kernels
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import index_lists_on


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


jax_sparse_module = importlib.import_module("deepspeed_tpu.ops.sparse_attention.sparse_self_attention")

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4

# (config class, constructor arguments, sequence length)
LAYOUT_CASES = [
    ("DenseSparsityConfig", dict(num_heads=2, block=16), 64),
    ("FixedSparsityConfig", dict(num_heads=2, block=16), 256),
    ("FixedSparsityConfig", dict(num_heads=2, block=16, attention="unidirectional"), 256),
    ("FixedSparsityConfig", dict(num_heads=4, block=16, different_layout_per_head=True,
                                 num_different_global_patterns=4), 256),
    ("FixedSparsityConfig", dict(num_heads=4, block=32, different_layout_per_head=True,
                                 num_local_blocks=4, num_global_blocks=2,
                                 num_different_global_patterns=2), 512),
    ("FixedSparsityConfig", dict(num_heads=2, block=16, horizontal_global_attention=True), 256),
    ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=3,
                                 attention="unidirectional"), 160),
    ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=3), 160),
    ("FixedSparsityConfig", dict(num_heads=16, block=16, num_local_blocks=4, num_global_blocks=1,
                                 attention="unidirectional"), 1024),
    ("VariableSparsityConfig", dict(num_heads=2, block=16), 128),
    ("VariableSparsityConfig", dict(num_heads=3, block=16, different_layout_per_head=True,
                                    num_random_blocks=2, local_window_blocks=[1, 2, 4],
                                    global_block_indices=[0, 5], seed=3), 256),
    ("VariableSparsityConfig", dict(num_heads=2, block=16, num_random_blocks=2,
                                    attention="unidirectional", seed=1), 256),
    ("VariableSparsityConfig", dict(num_heads=2, block=16, global_block_indices=[0, 5],
                                    global_block_end_indices=[2, 7],
                                    horizontal_global_attention=True), 256),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=16), 128),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16, different_layout_per_head=True,
                                   num_random_blocks=2, num_global_blocks=2, seed=5), 256),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=16, num_random_blocks=2,
                                   attention="unidirectional", seed=2), 256),
    ("BigBirdSparsityConfig", dict(num_heads=16, block=64, num_random_blocks=3,
                                   num_sliding_window_blocks=3, num_global_blocks=2,
                                   different_layout_per_head=True, seed=0), 4096),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16), 128),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16, global_block_indices=[0, 3],
                                        global_block_end_indices=[1, 5]), 256),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16, attention="unidirectional",
                                        global_block_indices=[2]), 256),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16), 128),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=16, num_sliding_window_blocks=5,
                                              attention="bidirectional"), 128),
]

# (config class, constructor arguments, sequence length or None): bad arguments
ERROR_CASES = [
    ("FixedSparsityConfig", dict(num_heads=2, num_local_blocks=4, num_global_blocks=3), None),
    ("FixedSparsityConfig", dict(num_heads=2, attention="sideways"), None),
    ("FixedSparsityConfig", dict(num_heads=2, attention="unidirectional",
                                 horizontal_global_attention=True), None),
    ("FixedSparsityConfig", dict(num_heads=2, num_different_global_patterns=2), None),
    ("FixedSparsityConfig", dict(num_heads=2, different_layout_per_head=True,
                                 num_different_global_patterns=8), None),
    ("VariableSparsityConfig", dict(num_heads=2, attention="sideways"), None),
    ("VariableSparsityConfig", dict(num_heads=2, attention="unidirectional",
                                    horizontal_global_attention=True), None),
    ("VariableSparsityConfig", dict(num_heads=2, global_block_indices=[0, 1],
                                    global_block_end_indices=[2]), None),
    ("BigBirdSparsityConfig", dict(num_heads=2, attention="sideways"), None),
    ("BigBirdSparsityConfig", dict(num_heads=2, num_random_blocks=5), 64),
    ("BigBirdSparsityConfig", dict(num_heads=2, num_global_blocks=5), 64),
    ("BSLongformerSparsityConfig", dict(num_heads=2, num_sliding_window_blocks=7), 64),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, num_sliding_window_blocks=9), 64),
    ("DenseSparsityConfig", dict(num_heads=2, block=16), 70),
    ("SparsityConfig", dict(num_heads=2), 64),
]


def _case_id(case):
    name, kw, seq = case
    return f"{name[:-14]}-{seq}-" + "-".join(f"{k}={v}" for k, v in kw.items())


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares the type
        return type(e)
    return None


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=_case_id)
def test_layouts_equal_jax_bit_for_bit(case):
    name, kw, seq = case
    ours, theirs = getattr(port_sparse, name)(**kw), getattr(jax_sparse, name)(**kw)
    for _ in range(2):  # the second call continues the same random stream
        got, want = ours.make_layout(seq), theirs.make_layout(seq)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ERROR_CASES, ids=_case_id)
def test_bad_arguments_raise_what_jax_raises(case):
    name, kw, seq = case

    def build(module):
        cfg = getattr(module, name)(**kw)
        if seq is not None:
            cfg.make_layout(seq)

    want = _raised(lambda: build(jax_sparse))
    assert want is not None
    assert _raised(lambda: build(port_sparse)) is want


def _random_layout(seed, h, n, density=0.4):
    rng = np.random.default_rng(seed)
    layout = (rng.random((h, n, n)) < density).astype(np.int64)
    layout[:, 1] = 0  # an empty query row
    layout[:, :, 2] = 0  # a key block nobody reads
    return layout


@pytest.mark.parametrize("layout", [
    _random_layout(0, 3, 8),
    np.zeros((1, 4, 4), np.int64),
    port_sparse.FixedSparsityConfig(num_heads=16, block=16,
                                    attention="unidirectional").make_layout(1024),
], ids=["random", "empty", "fixed-1024"])
def test_layout_index_lists_equal_jax(layout):
    got = port_sparse.layout_index_lists(layout)
    want = jax_sparse.layout_index_lists(layout)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def _inputs(seed, b, l, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, d), dtype=np.float32) for _ in range(4)]


def _port(q, k, v, w, layout, block, causal):
    """Output and q/k/v gradients of sum(o * w) through the port."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = port_sparse.sparse_attention(qt, kt, vt, layout, block, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    return o.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


def _jax(q, k, v, w, layout, block, causal):
    def fn(q_, k_, v_):
        return jax_sparse.sparse_attention(q_, k_, v_, layout, block, causal=causal)

    def loss(*a):
        o = fn(*a)
        return jnp.sum(o * jnp.asarray(w)), o

    args = [jnp.asarray(x) for x in (q, k, v)]
    # one program for the output and the gradients: each case compiles once
    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return np.asarray(o), [np.asarray(g) for g in grads]


# (config class, constructor arguments, causal, d)
KERNEL_CASES = [
    ("FixedSparsityConfig", dict(num_local_blocks=2), False, 32),
    ("FixedSparsityConfig", dict(num_local_blocks=2, attention="unidirectional"), True, 32),
    ("BigBirdSparsityConfig", dict(num_random_blocks=2, different_layout_per_head=True, seed=4),
     False, 16),
    ("BigBirdSparsityConfig", dict(num_random_blocks=2, attention="unidirectional", seed=1),
     True, 16),
    ("BSLongformerSparsityConfig", dict(global_block_indices=[1]), False, 32),
    ("BSLongformerSparsityConfig", dict(global_block_indices=[1]), True, 16),
    ("VariableSparsityConfig", dict(num_random_blocks=1, local_window_blocks=[2, 3],
                                    global_block_indices=[3], different_layout_per_head=True,
                                    seed=7), False, 16),
    ("VariableSparsityConfig", dict(num_random_blocks=1, attention="unidirectional", seed=2),
     True, 32),
    ("DenseSparsityConfig", {}, False, 16),
    ("DenseSparsityConfig", {}, True, 32),
]


def _kernel_id(case):
    name, kw, causal, d = case
    return f"{name[:-14]}-causal={causal}-d={d}-" + "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=_kernel_id)
def test_forward_and_gradients_match_jax(case, block):
    name, kw, causal, d = case
    b, l, h = 2, 128, 2
    layout = getattr(jax_sparse, name)(num_heads=h, block=block, **kw).make_layout(l)
    q, k, v, w = _inputs(block + d, b, l, h, d)
    before = dict(LAUNCHES)
    got_o, got_g = _port(q, k, v, w, layout, block, causal)
    assert LAUNCHES == before, "the plain versions on CPU tensors count no kernel launch"
    want_o, want_g = _jax(q, k, v, w, layout, block, causal)
    np.testing.assert_allclose(got_o, want_o, atol=FWD_ATOL, rtol=0)
    for name_, g, r in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, rtol=0, err_msg=f"d{name_}")


def test_forward_plain_matches_jax_kernel_lse():
    """K6's plain forward against the JAX ``_sp_fwd`` kernel itself: o and
    the log-sum-exp, NEG_INF on the rows of an empty query block."""
    b, l, h, d, block = 2, 96, 3, 16, 16
    layout = _random_layout(1, h, l // block)
    q, k, v, _ = _inputs(11, b, l, h, d)
    kidx, kcnt, qidx, qcnt = jax_sparse.layout_index_lists(layout)
    o, lse = jax_sparse_module._sp_fwd(*[jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)],
                                      jnp.asarray(kidx), jnp.asarray(kcnt), 0.25, False, block, True)
    lists = index_lists_on(layout, "cpu")
    got_o, got_lse = port_kernels.sparse_fwd_plain(*map(torch.from_numpy, (q, k, v)), *lists[:2],
                                                   scale=0.25, causal=False, block=block)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o).transpose(0, 2, 1, 3), atol=FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0], atol=FWD_ATOL, rtol=0)
    assert (got_lse[:, :, block:2 * block] == port_flash.NEG_INF).all()


@pytest.mark.parametrize("name,kw,causal", [
    ("FixedSparsityConfig", dict(num_local_blocks=2, attention="unidirectional"), None),
    ("BigBirdSparsityConfig", dict(num_random_blocks=1, different_layout_per_head=True, seed=9),
     None),
    ("BSLongformerSparsityConfig", {}, True),
])
def test_sparse_self_attention_matches_jax_wrapper(name, kw, causal):
    b, l, h, d = 1, 64, 2, 16
    q, k, v, w = _inputs(3, b, l, h, d)
    ours = port_sparse.SparseSelfAttention(getattr(port_sparse, name)(num_heads=h, block=16, **kw))
    theirs = jax_sparse.SparseSelfAttention(getattr(jax_sparse, name)(num_heads=h, block=16, **kw))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = ours(qt, kt, vt, causal=causal)
    (got * torch.from_numpy(w)).sum().backward()
    want = theirs(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)
    # causal inferred from the config, as in JAX, when not given
    inferred = getattr(ours.sparsity_config, "attention", "bidirectional") == "unidirectional"
    assert causal is not None or inferred == (name == "FixedSparsityConfig")
    # the layout is cached per seq_len, the index lists per (seq_len, device)
    assert 64 in ours._layouts and (64, torch.device("cpu")) in ours._index_lists
    lists = ours.get_index_lists(64, "cpu")
    ours(qt, kt, vt, causal=causal)
    assert all(a is b_ for a, b_ in zip(lists, ours._index_lists[(64, torch.device("cpu"))]))
    for got_l, want_l in zip(lists, jax_sparse.layout_index_lists(theirs.get_layout(64))):
        np.testing.assert_array_equal(got_l.numpy(), want_l)
    assert all(g is not None and np.isfinite(g.numpy()).all() for g in (qt.grad, kt.grad, vt.grad))


def _probe_layouts():
    """JAX's own NaN probe (every row reads block 0 and its diagonal, block
    2's column dead), and one whose dead column is block 0, where the
    padded list entries (index 0) point at the NaN block."""
    jax_probe = np.zeros((1, 4, 4), np.int64)
    jax_probe[0, :, 0] = 1
    jax_probe[0] |= np.eye(4, dtype=np.int64)
    jax_probe[0, 2, 2] = 0
    padded = np.zeros((2, 4, 4), np.int64)
    padded[:, 1:, 1] = 1  # query block 0 reads nothing: its list is all padding
    padded[:, 2:, 3] = 1
    padded[1, 3, 2] = 1
    return [(jax_probe, 2), (padded, 0)]


@pytest.mark.parametrize("layout,dead", _probe_layouts(), ids=["jax-probe", "padded-entries"])
@pytest.mark.parametrize("causal", [False, True])
def test_dead_blocks_truly_skipped_forward_and_backward(layout, dead, causal):
    """NaNs in the K/V rows of a block no query block reads: o, dq, dk and
    dv are finite, dk = dv = 0 in that block, and both match JAX."""
    b, block, d = 1, 16, 16
    h, n = layout.shape[:2]
    l = n * block
    q, k, v, w = _inputs(1, b, l, h, d)
    rows = slice(dead * block, (dead + 1) * block)
    k[:, rows] = np.nan
    v[:, rows] = np.nan
    got_o, got_g = _port(q, k, v, w, layout, block, causal)
    for x in [got_o] + got_g:
        assert np.isfinite(x).all(), "a dead block leaked into a product"
    assert (got_g[1][:, rows] == 0).all() and (got_g[2][:, rows] == 0).all()
    want_o, want_g = _jax(q, k, v, w, layout, block, causal)
    np.testing.assert_allclose(got_o, want_o, atol=FWD_ATOL, rtol=0)
    for g, r in zip(got_g, want_g):
        np.testing.assert_allclose(g, r, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_layout_equals_the_flash_plain_versions(causal):
    b, l, h, d, block = 2, 64, 2, 16, 16
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, b, l, h, d))
    lists = index_lists_on(np.ones((h, l // block, l // block), np.int64), "cpu")
    scale = d**-0.5
    o, lse = port_kernels.sparse_fwd_plain(q, k, v, *lists[:2], scale=scale, causal=causal,
                                           block=block)
    fo, flse = port_flash.flash_fwd_plain(q, k, v, scale=scale, causal=causal)
    np.testing.assert_allclose(o.numpy(), fo.numpy(), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), flse.numpy(), atol=FWD_ATOL, rtol=0)
    got = port_kernels.sparse_bwd_plain(q, k, v, o, lse, do, *lists, scale=scale, causal=causal,
                                        block=block)
    want = port_flash.flash_bwd_plain(q, k, v, fo, flse, do, scale=scale, causal=causal)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=FWD_ATOL, rtol=0)


def _masked_reference(q, k, v, layout, block, causal):
    """O(L^2) reference in float64 with the block mask materialized; rows
    with no live key give zero output (the JAX test's ``_dense_reference``
    contract)."""
    b, l, h, d = q.shape
    mask = torch.from_numpy(np.kron(layout, np.ones((block, block))) > 0)  # [h, l, l]
    if causal:
        mask = mask & torch.ones(l, l, dtype=torch.bool).tril()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, torch.zeros(()))
    return torch.einsum("bhqk,bkhd->bqhd", p.nan_to_num(0.0), v)


def test_above_diagonal_row_is_zero_where_the_jax_kernel_reads_ahead():
    """Layout [1, 4, 4], block 16, causal: query block 0 reads only key
    block 2, wholly above the diagonal. The port gives zero output and zero
    gradients there and equals the masked reference everywhere; the JAX
    kernel returns the mean of V over key block 2 for those rows and
    agrees with the port on every other row."""
    b, l, h, d, block = 1, 64, 1, 16, 16
    layout = np.tril(np.ones((1, 4, 4), np.int64))
    layout[0, 0] = [0, 0, 1, 0]
    q, k, v, w = _inputs(0, b, l, h, d)
    got_o, got_g = _port(q, k, v, w, layout, block, causal=True)
    want_o, want_g = _jax(q, k, v, w, layout, block, causal=True)

    first = slice(0, block)
    assert (got_o[:, first] == 0).all() and (got_g[0][:, first] == 0).all()
    np.testing.assert_allclose(want_o[0, first], np.broadcast_to(v[0, 32:48].mean(0), (block, h, d)),
                               atol=FWD_ATOL, rtol=0)
    assert np.abs(want_o[:, first]).max() > 0.1
    np.testing.assert_allclose(got_o[:, block:], want_o[:, block:], atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(got_g[0][:, block:], want_g[0][:, block:], atol=GRAD_ATOL, rtol=0)

    q64, k64, v64 = (torch.from_numpy(x).double().requires_grad_() for x in (q, k, v))
    ref = _masked_reference(q64, k64, v64, layout, block, causal=True)
    (ref * torch.from_numpy(w).double()).sum().backward()
    np.testing.assert_allclose(got_o, ref.detach().numpy(), atol=FWD_ATOL, rtol=0)
    for g, r in zip(got_g, (q64.grad, k64.grad, v64.grad)):
        np.testing.assert_allclose(g, r.numpy(), atol=GRAD_ATOL, rtol=0)
    # the JAX kernel's dv there carries the rows that read ahead
    assert np.abs(want_g[2][:, 32:48] - got_g[2][:, 32:48]).max() > 0.1


def test_length_must_be_a_multiple_of_the_block():
    q = torch.zeros(1, 40, 2, 16)
    lists = index_lists_on(np.ones((2, 2, 2), np.int64), "cpu")
    with pytest.raises(ValueError, match="multiple"):
        port_kernels.sparse_fwd(q, q, q, *lists[:2], scale=1.0, causal=False, block=16)
    with pytest.raises(AssertionError, match="layout"):
        port_sparse.sparse_attention(q, q, q, np.ones((2, 3, 3), np.int64), 16)
