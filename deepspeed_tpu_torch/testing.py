"""Inputs with exactly known answers, for holding the flash-attention
kernels (K1, K4) to their result exactly rather than at a rounding
tolerance. Used by the card tests and ``chip_smoke.py``; nothing in the
port's paths calls it.
"""

from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda.flash_attention import live_pairs
from deepspeed_tpu_torch.ops.transformer.attention import NEG_INF


def _code(j: np.ndarray) -> np.ndarray:
    """Key j as ``32 (e[j % 32] + e[32 + j // 32])`` over 64 dims (0 for j < 0)."""
    out = np.zeros(j.shape + (64,), np.float32)
    idx = np.nonzero(j >= 0)
    out[idx + (j[idx] % 32,)] = 32.0
    out[idx + (32 + j[idx] // 32,)] = 32.0
    return out


def exact_probe(b: int, lq: int, lk: int, h: int, *, causal: bool,
                kv_lengths: Optional[list] = None, window: Optional[int] = None, seed: int = 0,
                dtype=torch.bfloat16, device="cpu") -> dict:
    """Attention inputs whose outputs and gradients are exact in bf16. Head
    dim 64, scale 1/8; keys are coded as in :func:`_code` (at most 1024).

    Each (batch, row, head) picks one live key c, which the softmax must
    return one-hot: c scores 4096 (512 after scaling, a power of two, so
    ``exp(s - lse)`` is exactly 1), every other live key at most 3072, whose
    p underflows to 0. In about half the rows the highest-scoring key of all
    is instead a dead decoy d just past a boundary of the row's live range
    (the causal diagonal or kv_lengths above it, the window's edge below it):
    q = code(c) + 2 code(d) with c a live key that shares a coordinate with
    d, so d scores 5120 and would win the softmax if a mask let it in. A row
    with no live key gets a decoy among all keys. v and do are small
    integers, so o is v's row c, lse is 512, dv sums the rows of do that
    picked each key, and dq = dk = 0 (ds = p (dp - delta) with dp = delta
    exactly); rows with no live key give o = 0, lse = NEG_INF / 2. Both a
    live key masked out and a dead key let in change o by a whole row of v.

    Returns the inputs (``q, k, v, do, kv_lengths`` [int32 or None],
    ``scale``), the exact results (``o, lse, dq, dk, dv``) and the numpy
    ``[b, lq, h]`` arrays ``pick`` and ``decoy`` (-1 where none)."""
    if lk > 1024:
        raise ValueError(f"exact_probe codes at most 1024 keys, got {lk}")
    lens = None if kv_lengths is None else torch.tensor(kv_lengths, dtype=torch.int32)
    valid = live_pairs(lq, lk, causal, lens, window, "cpu").expand(b, 1, lq, lk)[:, 0].numpy()
    rng = np.random.default_rng(seed)
    keys = np.arange(lk)
    pick = np.full((b, lq, h), -1)
    decoy = np.full((b, lq, h), -1)
    for bi in range(b):
        for r in range(lq):
            live = np.nonzero(valid[bi, r])[0]
            edges = [] if not len(live) else [j for j in (live[0] - 1, live[-1] + 1) if 0 <= j < lk]
            for hi in range(h):
                if not len(live):
                    decoy[bi, r, hi] = rng.integers(lk)
                    continue
                if edges and rng.random() < 0.5:
                    d = edges[rng.integers(len(edges))]
                    near = live[(live % 32 == d % 32) | (live // 32 == d // 32)]
                    if len(near):
                        pick[bi, r, hi], decoy[bi, r, hi] = near[rng.integers(len(near))], d
                        continue
                pick[bi, r, hi] = live[rng.integers(len(live))]

    # a decoy row weighs c once and d twice, a plain row c twice; a dead row d once
    has_d = decoy >= 0
    q = (np.where(has_d, 1.0, 2.0)[..., None] * _code(pick)
         + np.where(pick >= 0, 2.0, 1.0)[..., None] * _code(decoy)).astype(np.float32)
    k = _code(np.broadcast_to(keys[None, :, None], (b, lk, h)))
    v = rng.integers(-4, 5, (b, lk, h, 64)).astype(np.float32)
    do = rng.integers(-4, 5, (b, lq, h, 64)).astype(np.float32)
    o, dv = np.zeros_like(do), np.zeros_like(v)
    bi, ri, hi = np.nonzero(pick >= 0)
    o[bi, ri, hi] = v[bi, pick[bi, ri, hi], hi]
    np.add.at(dv, (bi, pick[bi, ri, hi], hi), do[bi, ri, hi])
    lse = np.where(pick >= 0, 512.0, NEG_INF / 2).astype(np.float32).transpose(0, 2, 1)

    def put(x, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dt)

    return dict(q=put(q), k=put(k), v=put(v), do=put(do), scale=0.125,
                kv_lengths=None if lens is None else lens.to(device), o=put(o),
                lse=put(lse, torch.float32), dq=put(np.zeros_like(q)), dk=put(np.zeros_like(k)),
                dv=put(dv), pick=pick, decoy=decoy)
