"""The kernels' work plans, which decide on the host (K2) or on the device
from the slots' lengths (K3) what each thread block computes, hold each
operand row exactly once.

K2 (``ops/cuda/quant_matmul.py``): the body a call takes, and its split of
K over blocks, which must cover every row of K exactly once in whole 64-row
steps (so an int4 byte never straddles two splits), within the tensor-core
bodies' one-cluster limit and the decode body's staging limit. K3
(``ops/cuda/attention_geometry.py`` ``decode_blocks``, the plan the kernel
computes from ``lengths``): over each query row, the blocks that do work
read every live key exactly once, none starts past the live keys of its
rows, and a row with no live key gets the block that writes its zeros. The
live keys themselves are the plain version's mask.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import quant_matmul as qm
from deepspeed_tpu_torch.ops.cuda.attention_geometry import (DECODE_CHUNK, DECODE_TILE_ROWS,
                                                              QMM_GEMV_MAX_K_CHUNK, QMM_K_STEP,
                                                              QMM_MAX_CLUSTER, decode_blocks,
                                                              decode_body, decode_row_limit)

# ragged M and N, K not a multiple of the 64-row step, the serving shapes
QMM_SHAPES = [(1, 1024, 1024), (8, 1024, 3072), (8, 4096, 1024), (16, 320, 272), (17, 1024, 4096),
              (128, 4096, 1024), (130, 1024, 1024), (5, 96, 40), (3, 33, 5), (64, 16384, 128)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("body", ["fma", "gemv", "mma"])
@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
def test_quant_matmul_split_covers_k_once(m, k, n, body, bits):
    if body == "gemv" and k > QMM_MAX_CLUSTER * QMM_GEMV_MAX_K_CHUNK:
        assert qm.qmm_body(m, k, n, 64, True, True) != "gemv"  # never planned for the decode body
        return
    k_chunk, splits = qm.split_k(m, k, n, body, bits)
    assert k_chunk % QMM_K_STEP == 0 and k_chunk % 2 == 0 and splits >= 1
    rows = np.zeros(k, np.int64)
    for z in range(splits):
        rows[z * k_chunk:min(k, (z + 1) * k_chunk)] += 1
    assert (rows == 1).all(), "a row of K is read by no split or by two"
    assert (splits - 1) * k_chunk < k  # no split is empty
    if body != "fma":
        assert splits <= QMM_MAX_CLUSTER
    if body == "gemv":
        assert k_chunk <= QMM_GEMV_MAX_K_CHUNK


@pytest.mark.parametrize("m,k,n,group,bf16,aligned,want", [
    (8, 1024, 4096, 64, True, True, "gemv"),
    (1, 1024, 1024, 64, True, True, "gemv"),
    (16, 1024, 3072, 64, True, True, "gemv"),
    (17, 1024, 3072, 64, True, True, "mma"),
    (128, 1024, 4096, 64, True, True, "mma"),
    (8, 8192, 1024, 64, True, True, "mma"),     # more K than one cluster of the decode body stages
    (128, 1024, 4096, 64, False, True, "fma"),  # fp32
    (8, 96, 40, 32, True, True, "fma"),         # N not a multiple of 16
    (8, 96, 48, 48, True, True, "gemv"),       # a group of 48 rows, not a divisor of 64
    (8, 99, 48, 33, True, True, "fma"),         # a group of 33 rows
    (8, 1024, 4096, 64, True, False, "fma"),    # not 16-byte aligned
])
def test_quant_matmul_body_choice(m, k, n, group, bf16, aligned, want):
    assert qm.qmm_body(m, k, n, group, bf16, aligned) == want


def _live_mask(lengths, lq, p_len):
    """[S, Lq, P] keys each query row reads, as ``flash_decode_plain`` masks them."""
    lens = torch.tensor(lengths).long()
    q_pos = lens[:, None] - lq + torch.arange(lq)[None, :]
    k_pos = torch.arange(p_len)
    return ((k_pos[None, None, :] <= q_pos[:, :, None])
            & (k_pos[None, None, :] < lens.clamp(0, p_len)[:, None, None])).numpy()


@pytest.mark.parametrize("body", ["rows", "tiles"])
@pytest.mark.parametrize("lq", [1, 16, 20])
def test_decode_blocks_read_every_live_key_once(body, lq):
    p_len = 512
    rng = np.random.default_rng(lq)
    lengths = [0, 1, 15, 16, p_len - 1, p_len, p_len + lq, 300] + list(rng.integers(0, p_len, 8))
    live = _live_mask(lengths, lq, p_len)
    for s, length in enumerate(lengths):
        reads = np.zeros((lq, p_len), np.int64)
        covered = np.zeros(lq, bool)
        for rows, keys in decode_blocks(length, lq, p_len, body):
            assert len(rows) == (DECODE_TILE_ROWS if body == "tiles" else 1) or rows[-1] == lq - 1
            covered[list(rows)] = True
            limit = max(decode_row_limit(length, lq, p_len, r) for r in rows)
            if keys is None:  # the block that writes zeros: no row of it reads a key
                assert limit == 0
                continue
            assert keys.start < limit, "a block starts past the live keys of its rows"
            assert len(keys) <= DECODE_CHUNK[body]
            for r in rows:
                own = decode_row_limit(length, lq, p_len, r)
                reads[r, keys.start:min(keys.stop, own)] += 1
        np.testing.assert_array_equal(reads, live[s].astype(np.int64), err_msg=f"length {length}")
        assert covered.all(), f"a row of length {length} has no block to write it"


def test_decode_body_choice():
    assert decode_body(True, 1) == "rows" and decode_body(False, 16) == "rows"
    assert decode_body(True, 16) == "tiles" and decode_body(True, 2) == "tiles"
