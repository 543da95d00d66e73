"""The port's ``PagedKVCache`` against the JAX package's on the same
appends.

Both caches (6 pages of 4 positions, 2 heads, head dim 8, 2 layers) take
the same seeded K/V appends, split across page edges: fp32 pools must
gather identical views, int8 pools identical codes, bf16 scales and
dequantized views; ``pad_to``, block tables, freeing and reusing pages,
the allocator counters and the exhaustion error must agree.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.paged_kv import PagedKVCache as JaxPagedKVCache
from deepspeed_tpu_torch.inference import PagedKVCache

PAGES, PAGE, HEADS, DIM, LAYERS = 6, 4, 2, 8, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(quantize):
    jax_cache = JaxPagedKVCache(PAGES, PAGE, HEADS, DIM, num_layers=LAYERS, dtype=jnp.float32,
                                quantize=quantize)
    port = PagedKVCache(PAGES, PAGE, HEADS, DIM, num_layers=LAYERS, dtype=torch.float32,
                        quantize=quantize, device="cpu")
    return jax_cache, port


def _append(caches, seq, t, rng):
    for layer in range(LAYERS):
        k = rng.normal(size=(t, HEADS, DIM)).astype(np.float32)
        v = rng.normal(size=(t, HEADS, DIM)).astype(np.float32)
        caches[0].append(seq, jnp.asarray(k), jnp.asarray(v), layer=layer)
        caches[1].append(seq, torch.from_numpy(k), torch.from_numpy(v), layer=layer)


def _same_gather(caches, seqs, pad_to=None):
    for layer in range(LAYERS):
        jk, jv, jl = caches[0].gather(seqs, layer=layer, pad_to=pad_to)
        k, v, lengths = caches[1].gather(seqs, layer=layer, pad_to=pad_to)
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(jl))
        for got, want in ((k, jk), (v, jv)):
            assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
            # rows past a sequence's length are dead (page 0's rows)
            for i, n in enumerate(np.asarray(jl)):
                np.testing.assert_array_equal(got[i, :n].numpy(), np.asarray(want)[i, :n])


@pytest.mark.parametrize("quantize", [False, True])
def test_appends_gathers_and_allocator_match_jax(quantize):
    caches = _pair(quantize)
    rng = np.random.default_rng(0)
    for seq in (0, 1, 2):
        for c in caches:
            c.allocate(seq)
    _append(caches, 0, 3, rng)   # inside page 0
    _append(caches, 1, 6, rng)   # across a page edge
    _append(caches, 0, 2, rng)   # seq 0 crosses into its second page
    _append(caches, 2, 1, rng)
    for seq in (0, 1, 2):
        assert caches[1].seq_len(seq) == caches[0].seq_len(seq)
        assert caches[1].block_table(seq) == caches[0].block_table(seq)
    if quantize:
        np.testing.assert_array_equal(caches[1].k_pool.numpy(), np.asarray(caches[0].k_pool))
        np.testing.assert_array_equal(caches[1].v_pool.numpy(), np.asarray(caches[0].v_pool))
        for got, want in ((caches[1].k_scale, caches[0].k_scale),
                          (caches[1].v_scale, caches[0].v_scale)):
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    _same_gather(caches, [0, 1, 2])
    _same_gather(caches, [1, 2], pad_to=12)
    assert caches[1].counters() == caches[0].counters()
    assert caches[1].free_pages == caches[0].free_pages
    assert caches[1].utilization() == caches[0].utilization()

    # free and reuse: seq 1's pages go back to the pool and serve seq 3
    for c in caches:
        c.free(1)
        c.allocate(3)
    _append(caches, 3, 5, rng)
    assert caches[1].block_table(3) == caches[0].block_table(3)
    _same_gather(caches, [0, 3])
    assert caches[1].counters() == caches[0].counters()

    # exhaustion: the same error, and nothing half-written
    for c in caches:
        with pytest.raises(RuntimeError, match="KV page pool exhausted"):
            c._ensure_capacity(2, PAGES * PAGE)
    assert caches[1].counters() == caches[0].counters()


def test_pad_to_shorter_than_a_sequence_raises():
    _, port = _pair(False)
    port.allocate(0)
    port.append(0, torch.zeros(5, HEADS, DIM), torch.zeros(5, HEADS, DIM), layer=0)
    port.append(0, torch.zeros(5, HEADS, DIM), torch.zeros(5, HEADS, DIM), layer=1)
    with pytest.raises(ValueError, match="pad_to"):
        port.gather([0], pad_to=4)
