"""Inputs with exactly known answers, for holding the attention kernels
(K1 and K4: :func:`exact_probe`; K6: :func:`sparse_exact_probe`; K3:
:func:`decode_exact_probe`) to their result exactly rather than at a
rounding tolerance, inputs on which K2 must give its plain version's bits
(:func:`quant_matmul_probe`), and
:func:`injected_routing`, which holds the MoE gate to given decisions so
that two runs can be compared under one routing. Used by the tests and
``chip_smoke.py``; nothing in the port's paths calls it.
"""

import contextlib
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.moe import sharded_moe
from deepspeed_tpu_torch.ops.cuda.attention_geometry import decode_row_limit
from deepspeed_tpu_torch.ops.cuda.flash_attention import live_pairs
from deepspeed_tpu_torch.ops.transformer.attention import NEG_INF


def _code(j: np.ndarray, head_dim: int = 64) -> np.ndarray:
    """Key j as ``32 (e[j % m] + e[m + j // m])`` over ``head_dim`` dims,
    m = head_dim / 2 (0 for j < 0): at most m^2 keys, 1024 at head dim 64
    and 4096 at 128."""
    m = head_dim // 2
    out = np.zeros(j.shape + (head_dim,), np.float32)
    idx = np.nonzero(j >= 0)
    out[idx + (j[idx] % m,)] = 32.0
    out[idx + (m + j[idx] // m,)] = 32.0
    return out


def _near(live: np.ndarray, d: int, head_dim: int) -> np.ndarray:
    """The keys of ``live`` whose code shares a coordinate with key d's."""
    m = head_dim // 2
    return live[(live % m == d % m) | (live // m == d // m)]


def exact_probe(b: int, lq: int, lk: int, h: int, *, causal: bool,
                kv_lengths: Optional[list] = None, window: Optional[int] = None, seed: int = 0,
                dtype=torch.bfloat16, device="cpu", head_dim: int = 64) -> dict:
    """Attention inputs whose outputs and gradients are exact in bf16. Head
    dim ``head_dim`` (64 or 128), scale 1/8; keys are coded as in
    :func:`_code` (at most 1024 keys at head dim 64, 4096 at 128).

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
    if lk > (head_dim // 2)**2:
        raise ValueError(f"exact_probe codes at most {(head_dim // 2)**2} keys at head dim "
                         f"{head_dim}, got {lk}")
    lens = None if kv_lengths is None else torch.tensor(kv_lengths, dtype=torch.int32)
    valid = live_pairs(lq, lk, causal, lens, window, "cpu").expand(b, 1, lq, lk)[:, 0].numpy()
    rng = np.random.default_rng(seed)
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
                    near = _near(live, d, head_dim)
                    if len(near):
                        pick[bi, r, hi], decoy[bi, r, hi] = near[rng.integers(len(near))], d
                        continue
                pick[bi, r, hi] = live[rng.integers(len(live))]
    return _one_hot_inputs(pick, decoy, lk, rng, lens, dtype, device, NEG_INF / 2, head_dim)


def _one_hot_inputs(pick, decoy, lk, rng, lens, dtype, device, dead_lse, head_dim=64) -> dict:
    """The probe's tensors for chosen ``pick`` / ``decoy`` keys [b, lq, h]:
    q, k, v, do and the exact o, lse, dq, dk, dv (see :func:`exact_probe`)."""
    b, _, h = pick.shape
    # a decoy row weighs c once and d twice, a plain row c twice; a dead row d once
    has_d = decoy >= 0
    q = (np.where(has_d, 1.0, 2.0)[..., None] * _code(pick, head_dim)
         + np.where(pick >= 0, 2.0, 1.0)[..., None] * _code(decoy, head_dim)).astype(np.float32)
    k = _code(np.broadcast_to(np.arange(lk)[None, :, None], (b, lk, h)), head_dim)
    v = rng.integers(-4, 5, (b, lk, h, head_dim)).astype(np.float32)
    do = rng.integers(-4, 5, pick.shape + (head_dim,)).astype(np.float32)
    o, dv = np.zeros_like(do), np.zeros_like(v)
    bi, ri, hi = np.nonzero(pick >= 0)
    o[bi, ri, hi] = v[bi, pick[bi, ri, hi], hi]
    np.add.at(dv, (bi, pick[bi, ri, hi], hi), do[bi, ri, hi])
    lse = np.where(pick >= 0, 512.0, dead_lse).astype(np.float32).transpose(0, 2, 1)

    def put(x, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dt)

    return dict(q=put(q), k=put(k), v=put(v), do=put(do), scale=0.125,
                kv_lengths=None if lens is None else lens.to(device), o=put(o),
                lse=put(lse, torch.float32), dq=put(np.zeros_like(q)), dk=put(np.zeros_like(k)),
                dv=put(dv), pick=pick, decoy=decoy)


def _probe_layout(h: int, n: int, *, causal: bool, seed: int = 0) -> np.ndarray:
    """A per-head random [h, n, n] 0/1 layout in which every query block has
    a live block: under ``causal`` the diagonal is always in it (no query
    block is left above the diagonal only); otherwise each row has at least
    one block and, for n >= 3, key block n - 2 is read by no query block."""
    rng = np.random.default_rng(seed)
    layout = rng.random((h, n, n)) < 0.35
    if causal:
        layout[:, np.arange(n), np.arange(n)] = True
    else:
        if n >= 3:
            layout[:, :, n - 2] = False
        for hi, r in zip(*np.nonzero(~layout.any(axis=2))):
            layout[hi, r, rng.choice([j for j in range(n) if n < 3 or j != n - 2])] = True
    return layout.astype(np.int64)


def sparse_exact_probe(b: int, l: int, h: int, block: int, *, causal: bool, seed: int = 0,
                       layout: Optional[np.ndarray] = None, dtype=torch.bfloat16,
                       device="cpu") -> dict:
    """Block-sparse attention inputs whose outputs and gradients are exact
    in bf16: :func:`exact_probe`'s one-hot rows over a layout (``layout``
    [h, l / block, l / block], by default :func:`_probe_layout`) in which
    every query block has live blocks, so every row has a live key. Each
    (batch, row, head) picks a live key; in about half the rows a dead
    decoy would win the softmax if let in: a key in a block the row's
    layout leaves out, or under ``causal`` the key just past the row inside
    its diagonal block. o is v's picked row, lse 512, dv sums the rows of do
    that picked each key, dq = dk = 0; a live key masked out, a dead block
    loaded, a wrong list entry or a wrong fragment-to-(row, key) mapping
    each show as an error of a whole v row.

    Returns :func:`exact_probe`'s keys (``kv_lengths`` None) and the
    ``layout``; ``decoy_kind`` [b, l, h] is 1 for a decoy in a dead block,
    2 for one past the diagonal, 0 for none."""
    if l > 1024 or l % block:
        raise ValueError(f"sparse_exact_probe codes at most 1024 keys in whole blocks, got "
                         f"{l} keys in blocks of {block}")
    n = l // block
    layout = _probe_layout(h, n, causal=causal, seed=seed) if layout is None else layout
    layout = np.asarray(layout, bool)
    if layout.shape != (h, n, n):
        raise ValueError(f"layout {layout.shape} != ({h}, {n}, {n})")
    valid = layout.repeat(block, 1).repeat(block, 2)  # [h, l, l]
    if causal:
        valid &= np.tri(l, dtype=bool)
    rng = np.random.default_rng(seed)
    pick = np.full((b, l, h), -1)
    decoy = np.full((b, l, h), -1)
    kind = np.zeros((b, l, h), np.int64)
    for hi in range(h):
        for r in range(l):
            live = np.nonzero(valid[hi, r])[0]
            if not len(live):
                raise ValueError(f"query row {r} of head {hi} has no live key in the layout")
            dead_blocks = np.nonzero(~layout[hi, r // block])[0]
            past = r + 1 if causal and (r + 1) % block else -1
            for bi in range(b):
                choice = []
                if len(dead_blocks):
                    choice.append((1, dead_blocks[rng.integers(len(dead_blocks))] * block
                                   + rng.integers(block)))
                if past >= 0:
                    choice.append((2, past))
                if choice and rng.random() < 0.5:
                    kd, d = choice[rng.integers(len(choice))]
                    near = _near(live, d, 64)
                    if len(near):
                        pick[bi, r, hi], decoy[bi, r, hi] = near[rng.integers(len(near))], d
                        kind[bi, r, hi] = kd
                        continue
                pick[bi, r, hi] = live[rng.integers(len(live))]
    out = _one_hot_inputs(pick, decoy, l, rng, None, dtype, device, NEG_INF)
    out.update(layout=layout.astype(np.int64), decoy_kind=kind)
    return out


def _injected_top1(logits, routing, used_token):
    """Top-1 decisions ``routing`` ([S, 1] fields) on this call's logits:
    the gate probability of the injected expert as the combine weight (0
    where dropped), and the load-balancing loss and expert counts of the
    injected first choices."""
    dev = logits.device
    expert, slot, keep = (t.reshape(-1, 1).to(dev) for t in
                          (routing.expert, routing.slot, routing.keep))
    num_experts = logits.shape[1]
    gates = torch.softmax(logits.float(), dim=1)
    mask1 = F.one_hot(expert[:, 0].long(), num_experts)
    if used_token is not None:
        mask1 = mask1 * used_token[:, None].to(mask1.dtype)
    l_aux = (gates.mean(dim=0) * mask1.float().mean(dim=0)).sum() * num_experts
    weight = gates.gather(1, expert.long()) * keep.float()
    return (l_aux, sharded_moe.SortedRouting(expert.int(), slot.int(), weight, keep.int()),
            mask1.sum(dim=0).int())


def _injected_top2(logits, routing):
    """Top-2 decisions ``routing`` ([S, 2] fields) on this call's logits:
    each kept copy's gate probability normalised over the token's kept
    copies (``_top2_decisions``' order of operations), the load-balancing
    loss and the expert counts of the injected first choices."""
    dev = logits.device
    expert, slot, keep = (t.reshape(-1, 2).to(dev) for t in
                          (routing.expert, routing.slot, routing.keep))
    num_experts = logits.shape[1]
    gates = torch.softmax(logits.float(), dim=1)
    mask1 = F.one_hot(expert[:, 0].long(), num_experts)
    l_aux = (gates.mean(dim=0) * mask1.float().mean(dim=0)).mean() * num_experts * num_experts
    kept = gates.gather(1, expert.long()) * keep.float()  # [S, 2], 0 where dropped
    denom = torch.clamp(kept[:, 0] + kept[:, 1], min=torch.finfo(torch.float32).eps)
    weight = kept / denom[:, None] * keep.float()
    return (l_aux, sharded_moe.SortedRouting(expert.int(), slot.int(), weight, keep.int()),
            mask1.sum(dim=0).int())


@contextlib.contextmanager
def injected_routing(routing=None, record=None, model: Optional[torch.nn.Module] = None):
    """Inside the block, every gate call of the sorted route (the decision
    cores ``sharded_moe.top1routing`` and ``top2routing``) records its own
    decisions into ``record`` (when given) and, when ``routing`` is given,
    returns that routing's expert, slot and keep instead, with what follows
    from them on this call's logits: the combine weight (top-1: the gate
    probability of the injected expert; top-2: the kept copies' gate
    probabilities normalised over the token's kept copies; 0 where
    dropped), and the load-balancing loss and the expert counts of the
    injected first choices. So a bf16 step and its plain version can be
    compared under one routing: a token that the two would route apart on
    a bf16 ulp no longer moves an expert's gradient by its whole share; and
    a test can inject the JAX package's decisions. Injecting a call's own
    decisions returns them unchanged.

    Without ``model``, ``routing`` is one :class:`SortedRouting` for every
    call and ``record`` a list each call appends to. With ``model``, each
    gate is named by its module name in ``model`` (``"layers_0.moe.
    deepspeed_moe.gate"``): ``routing`` is then a dict from gate name to
    routing, and ``record`` a dict from gate name to the list of that
    gate's calls (a checkpointed layer's recompute calls it again). Groups
    of one, as the port's single-device route has."""
    free1, free2 = sharded_moe.top1routing, sharded_moe.top2routing
    free_forward = sharded_moe.TopKGate.forward
    names = ({id(m): n for n, m in model.named_modules() if isinstance(m, sharded_moe.TopKGate)}
             if model is not None else {})
    calling: List[Optional[str]] = []

    def forward(self, *args, **kwargs):
        calling.append(names.get(id(self)))
        try:
            return free_forward(self, *args, **kwargs)
        finally:
            calling.pop()

    def keep_and_pick(out):
        name = calling[-1] if calling else None
        if record is not None:
            own = sharded_moe.SortedRouting(*(t.detach().cpu() for t in out[1]))
            (record.setdefault(name, []) if isinstance(record, dict) else record).append(own)
        if isinstance(routing, dict):
            return routing[name]
        return routing

    def gate1(logits, capacity_factor, min_capacity, used_token=None, noisy_gate_policy=None,
              drop_tokens=True, use_rts=True, gumbel=None, rts=None):
        out = free1(logits, capacity_factor, min_capacity, used_token, noisy_gate_policy,
                    drop_tokens, use_rts, gumbel, rts)
        chosen = keep_and_pick(out)
        return out if chosen is None else _injected_top1(logits, chosen, used_token)

    def gate2(logits, capacity_factor, min_capacity, drop_tokens=True, gumbel=None):
        out = free2(logits, capacity_factor, min_capacity, drop_tokens, gumbel)
        chosen = keep_and_pick(out)
        return out if chosen is None else _injected_top2(logits, chosen)

    sharded_moe.top1routing, sharded_moe.top2routing = gate1, gate2
    sharded_moe.TopKGate.forward = forward
    try:
        yield
    finally:
        sharded_moe.top1routing, sharded_moe.top2routing = free1, free2
        sharded_moe.TopKGate.forward = free_forward


def decode_exact_probe(lengths: List[int], lq: int, p_len: int, h: int, *, seed: int = 0,
                       dtype=torch.bfloat16, device="cpu", head_dim: int = 64) -> dict:
    """Decode attention inputs (K3) whose output is exact, in both operand
    forms: :func:`exact_probe`'s one-hot rows over a per-slot cache
    ``[S, p_len, h, head_dim]`` with ``lengths`` [S] (S * p_len at most 1024
    at head dim 64, 4096 at 128, so every cache row of every slot has its own
    code: key j of slot s is coded ``s * p_len + j``). Each (slot, row, head) with live keys picks one; in
    about half of them a dead decoy that would win the softmax if read sits
    just past the row's live range: the key after the row's position or
    after the slot's length, or, where the row reads the whole pool (a
    parked slot's length is ``p_len + lq``), the next slot's first key,
    which a read past the pool would reach. A row with no live key gets a
    decoy among all keys and must give 0.

    Returns ``q`` [S, lq, h, head_dim], ``k`` and ``v`` (values of ``dtype``),
    the same pool as int8 codes ``k_codes``, ``v_codes`` with scales
    ``k_scale``, ``v_scale`` [S, p_len, h, 1] of ``dtype`` (exact: codes
    times 0.5), int32 ``lengths``, ``scale`` 1/8 and the exact ``o``."""
    s_n = len(lengths)
    if s_n * p_len > (head_dim // 2)**2:
        raise ValueError(f"decode_exact_probe codes at most {(head_dim // 2)**2} cache rows at head "
                         f"dim {head_dim}, got {s_n} x {p_len}")
    rng = np.random.default_rng(seed)
    pick = np.full((s_n, lq, h), -1)
    decoy = np.full((s_n, lq, h), -1)
    for si, length in enumerate(lengths):
        for r in range(lq):
            limit = decode_row_limit(length, lq, p_len, r)
            if limit < p_len:
                edge = si * p_len + limit
            else:
                edge = (si + 1) * p_len if si + 1 < s_n else -1
            live = si * p_len + np.arange(limit)
            for hi in range(h):
                if not limit:
                    decoy[si, r, hi] = rng.integers(s_n * p_len)
                    continue
                if edge >= 0 and rng.random() < 0.5:
                    near = _near(live, edge, head_dim)
                    if len(near):
                        pick[si, r, hi], decoy[si, r, hi] = near[rng.integers(len(near))], edge
                        continue
                pick[si, r, hi] = live[rng.integers(len(live))]
    has_d = decoy >= 0
    q = (np.where(has_d, 1.0, 2.0)[..., None] * _code(pick, head_dim)
         + np.where(pick >= 0, 2.0, 1.0)[..., None] * _code(decoy, head_dim)).astype(np.float32)
    k = _code(np.broadcast_to((np.arange(s_n)[:, None] * p_len + np.arange(p_len))[..., None],
                              (s_n, p_len, h)), head_dim)
    v = rng.integers(-4, 5, (s_n, p_len, h, head_dim)).astype(np.float32)
    o = np.zeros(q.shape, np.float32)
    si, ri, hi = np.nonzero(pick >= 0)
    o[si, ri, hi] = v.reshape(s_n * p_len, h, head_dim)[pick[si, ri, hi], hi]

    def put(x, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dt)

    half = put(np.full((s_n, p_len, h, 1), 0.5, np.float32))
    return dict(q=put(q), k=put(k), v=put(v), k_codes=put(2 * k, torch.int8),
                v_codes=put(2 * v, torch.int8), k_scale=half, v_scale=half.clone(),
                lengths=torch.tensor(lengths, dtype=torch.int32, device=device), scale=0.125,
                o=put(o), pick=pick, decoy=decoy)


def quant_matmul_probe(m: int, k: int, n: int, bits: int, *, group: int = 64, hot: int = 4,
                       round_scales: bool = True, seed: int = 0, dtype=torch.bfloat16,
                       device="cpu") -> dict:
    """K2 inputs on which every order of summation gives the same bits, so
    a kernel must equal its plain version exactly: each row of x holds
    ``hot`` (at most 4) entries of +-1, the codes span their whole range,
    and the scales are ``(1 + r 2^-10) 2^-e`` with e in 0..4. Every
    dequantised weight is then a multiple of 2^-14 under 2^8 (rounded to
    bf16 or not), every partial sum is exact in fp32, and only the final
    rounding to x's dtype remains. With ``round_scales`` r is drawn from
    1..1023, so a weight times its scale is mostly not a bf16 value: a bf16
    kernel that skips rounding the dequantised weight before the product
    gives other bits in some outputs. With ``round_scales=False`` (r = 0,
    powers of two) every weight is exact in bf16: the integer probe.

    Returns ``x`` [m, k] of ``dtype``, ``qw`` (int8 [k, n], or int4 packed
    [k/2, n]), ``codes`` (unpacked int8) and ``scale`` fp32 [k/group, n]."""
    from deepspeed_tpu_torch.ops.quantizer.weights import pack_rows
    if hot > 4 or k % group:
        raise ValueError(f"quant_matmul_probe: hot <= 4 and group | k, got {hot}, {group}, {k}")
    rng = np.random.default_rng(seed)
    x = np.zeros((m, k), np.float32)
    for r in range(m):
        x[r, rng.choice(k, size=hot, replace=False)] = rng.choice([-1.0, 1.0], size=hot)
    lo, hi = (-127, 127) if bits == 8 else (-8, 7)
    codes = rng.integers(lo, hi + 1, (k, n)).astype(np.int8)
    r = rng.integers(1, 1024, (k // group, n)) if round_scales else 0
    scale = ((1.0 + r * 2.0**-10) * 2.0**-rng.integers(0, 5, (k // group, n))).astype(np.float32)
    codes_t = torch.from_numpy(codes).to(device)
    return dict(x=torch.from_numpy(x).to(device=device, dtype=dtype),
                qw=codes_t if bits == 8 else pack_rows(codes_t), codes=codes_t,
                scale=torch.from_numpy(scale).to(device))
