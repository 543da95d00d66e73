#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (the script then exits non-zero):

1. card     — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name.
2. build    — compile the kernels from ``deepspeed_tpu_torch/csrc`` with
              ``nvcc`` for sm_90a (one process per source, in parallel).
3. kernels  — each kernel (K1 flash forward, K2 int8/int4 dequant GEMM, K3
              flash decode, K4 flash backward: dq, dk and dv, K5 MoE row
              permutation: forward and VJP, K6 block-sparse attention:
              forward and backward) against its plain PyTorch version on the
              same inputs at the serving, training and sparse slices' shapes;
              max |err| / max |ref| must stay within 2e-2 in bf16 and 1e-4 in
              fp32, and K5, a gather, must be exact. K1, K4 and K6 also
              within 1e-6 of inputs whose result is exact (one-hot softmax
              rows, with a dead decoy key past each mask boundary, or in a
              block the layout leaves out, that would win if let in:
              ``deepspeed_tpu_torch.testing``), K6 in bf16 and fp32. K3 in both
              operand forms (bf16 values, and int8 codes with scales, which
              must give the value form's bits on the dequantised pool) at Lq 1
              and 16, and within 1e-6 of its own exact probe in both forms;
              K2's three bodies (decode M <= 16, prefill M > 16, the general
              FMA body) at every serving shape, ragged M and N, int8 and int4,
              and bit for bit equal to the plain version on inputs where every
              summation order gives the same bits (integer x; power-of-two or
              non-bf16 scales).
              Times the kernel, its plain version and one PyTorch library
              call, and computes the least time the card could take
              (``bound_ms``). For K1, K4, K5 and K6 the library time is the
              device time of the kernels SDPA (K5: ``index_select``)
              launches (``torch.profiler`` sums, so host launch gaps do not
              count), with the event-timed figure beside it, and the
              kernel's own device time (``device_ms``) is measured the same
              way, K4's and K6's by kernel (K6 also in natural launch order
              beside its longest-first one). K6's registers, local-memory bytes, HMMA
              and atomic instructions come from ``cuobjdump``: every bf16
              K6 kernel must hold HMMA instructions and none an atomic. K2 and
              its library call (a bf16 matmul over the dequantised weight) are
              timed device-side over rotating weight copies larger than the
              L2, at every serving shape; K3 device-side beside masked SDPA
              over the dequantised pool, whose dequantise pass is timed too.
              At head dim 128 (the LLaMA family) K1, K4 and K3 again: K1 and
              K4 in bf16 and fp32 with causal, kv_lengths and window masks,
              K3's row and tile bodies (Lq 1 and 16) in both operand forms,
              against their plain versions (2e-2 bf16, 1e-4 fp32) and within
              1e-6 of their exact probes at head dim 128; then at the LLaMA
              shapes (K1 [4,2048,16,128] causal, LLaMA-1b training, and
              [4,2048,32,128], LLaMA-7b's forward; K4 [4,2048,16,128]; K3
              q [4,1|16,32,128] over a [4,2048,32,128] cache) the kernel's
              event-timed and device time, its plain version's, SDPA's
              device time and the bound, and every head-dim-128 instance's
              registers and local-memory (spill) bytes from ``cuobjdump``.
4. serving  — GPT-2 350m (full width, 24 layers, random seeded weights, bf16):
              (a) ``init_inference(kernel_inject=True, use_flash_prefill=True)``,
              ``forward`` on [4, 1024] tokens and ``generate`` of 32 tokens for 2
              prompts; (b) ``ContinuousBatchingScheduler`` with int8 weights and
              int8 KV serving 16 greedy requests from a seeded trace; launch
              counts are zeroed just before (a) and read just after (b), and
              each kernel must have launched; a profile of 5 prefill ticks (8
              slots x 16 tokens) and of 10 decode ticks, each split into K2, K3,
              the int8 KV dequantise pass (none may be left on the flash path)
              and the rest; (c) the first prefill and decode
              ticks again through the same model on the CPU, where every
              kernel wrapper computes its plain version: logits held to 1e-4
              with both sides in fp32 (the check that catches a kernel
              fault), and in bf16 as served to 1.5x the rounding error the
              same run measures (plain bf16 with int8 KV against plain fp32).
5. training — the JAX bench's training step through ``initialize``: GPT-2
              350m (24 layers, vocab 50304), seq 1024, micro-batch 8, bf16
              over fp32 masters, remat, fused LM-head loss (chunk 1024), the
              ``"flash"`` backend, AdamW lr 1e-4 wd 0.01, clipping 1.0, one
              seeded batch repeated: 2 warm-up and 10 timed steps with launch
              counts zeroed just before and read just after (K1 and K4 must
              have launched), finite and falling loss, step ms, tokens/s and
              model TFLOP/s, and one steady step under ``torch.profiler``.
6. gradcheck — one training step of the same model at 2 layers, seq 512,
              batch 2 on the card and on the CPU (plain versions): the loss
              and every parameter's gradient within 1e-4 in fp32, and in bf16
              within 1.5x the rounding the same run measures (plain bf16
              against plain fp32).
7. MoE training — the same step with an MoE FFN of 8 GPT-2 MLP experts in
              every other block (top-1, capacity factor 1.25, RTS, the
              sorted route: ~1.06B parameters, ~355M active): 2 warm-up and
              10 timed steps with launch counts zeroed just before and read
              just after (per step K1 48, K4 24 and K5 72: 12 MoE layers x
              dispatch and combine x forward, remat recompute and backward),
              finite and falling loss, step ms, tokens/s, model TFLOP/s by
              active parameters, peak memory, and one profiled step.
8. MoE gradcheck — one step of a 2-layer MoE model (layer 1 MoE, top-1, no
              RTS, so routing is deterministic) on the card and on the CPU:
              in fp32 every token's expert and slot identical and the loss
              and every gradient within 1e-4; in bf16, with the plain bf16
              step's routing injected at the gate on the card and in the
              plain fp32 yardstick, within 1.5x the measured rounding; the
              free-routing share and the routing flips are reported.
9. sparse attention — ``SparseSelfAttention(cfg)(q, k, v)`` and
              ``.backward()`` on a seeded cotangent, bf16, 2 warm-up and 10
              timed iterations each, in two published layouts: (a) Sparse
              Transformer "fixed" (block 16, 4 local blocks, 1 global,
              unidirectional, so causal) at GPT-2 350m's training attention
              shape [8, 1024, 16, 64]; (b) BigBird ITC (block 64, 3 random,
              3 sliding, 2 global blocks, a layout per head, bidirectional)
              at [2, 4096, 16, 64]. Launch counts are zeroed just before and
              read just after: K6 forward and backward once per iteration,
              K1/K4 never. Then the path's o, dq, dk and dv against the plain
              versions (bf16, and the same path in fp32), the NaN probe on
              the card (NaN K/V rows in a key block the layout leaves dead:
              everything finite, dk = dv = 0 there), one profile of the
              path per layout (device busy and idle share; host time of
              the module's forward, K6's backward wrapper and autograd's
              rest), a dense layout against K1 and K4 (causal and not),
              and K1 + K4 at shape (a).
10. engine API and checkpoints — GPT-2 350m as in phase 5 at
              ``train_batch_size`` 16, micro-batch 8, ``gas`` 2: (a) 4 steps
              of ``train_batch`` twice from one seeded init (the card's own
              bit-determinism) and the same 8 micro-batches through
              ``forward``/``backward``/``step`` (``step()`` between
              boundaries must leave ``global_steps``): losses and final
              parameters bit-equal, on the ``"flash"`` backend at dropout 0
              (launch counts zeroed just before each side and read just
              after: K1 and K4 on both), and at dropout 0.1 on the ``"xla"``
              backend (the flash kernels take no dropout); (b) that dropout
              run saves ``step2`` and ``step4``, and a fresh engine loads
              ``step2`` (``verify_checkpoint="full"``) and trains steps 3-4
              to the same bits; (c) on hard-linked copies of the tags: a
              flipped byte and a truncated file in ``step4`` each fall back
              to ``step2`` with the error logged, and an explicit ``tag=``
              of a corrupt tag with nothing older raises
              ``CheckpointCorruptError``; (d) ``save_16bit_model``: 2 bytes a
              parameter, its bits equal to the parameters rounded to bf16;
              (e) a 2-layer MoE model at full width (8 experts, top-1, cf
              1.25, RTS): both APIs bit-equal, then save, load and resume
              bit-exact, K1, K4 and K5 launched; and, right after phase 7,
              ``moe_gate_stats`` on phase 7's engine leaves its next loss
              bit-equal. It prints the step ms of both APIs (6 pairs in
              turns on one warm engine) and the save's and the loads'
              seconds and GB, split by part; the checkpoints live in a temp
              dir, deleted at the end.

11. LLaMA-1b training — 24 layers, hidden 2048, 16 heads of 128, FFN 5504,
              vocab 32000 (random seeded weights) through ``initialize`` and
              ``train_batch``: micro-batch 4 at seq 2048, bf16 over fp32
              masters, remat, the fused head on the untied [E, V] kernel
              (chunk 1024), the ``"flash"`` backend, AdamW lr 1e-4 wd 0.01,
              clipping 1.0; 2 warm-up and 10 timed steps with launch counts
              zeroed just before and read just after (K1 48 and K4 24 a
              step), finite and falling loss, step ms, tokens/s, model
              TFLOP/s (the JAX bench's formula), peak memory and one
              profiled step by kernel family.
12. LLaMA gradcheck — one step on the card and on the CPU (plain
              versions), fp32 within 1e-4 and bf16 within 1.5x the measured
              rounding, as phase 6: (a) LLaMA-1b's width at 2 layers, batch
              2 x seq 512; (b) Mistral-7b's width at 2 layers (GQA 32/8, FFN
              14336) with ``sliding_window`` overridden from 4096 to 256 at
              seq 1024, so that the window mask bites in K1 and K4.
13. LLaMA-7b serving — 32 layers, 32 heads of 128, cache 2048, bf16
              (random seeded weights), ``init_inference(kernel_inject=True,
              use_flash_prefill=True)``: ``forward`` on [4, 2048] (K1 once a
              layer) and ``generate`` of 1 and of 64 greedy tokens for 4
              prompts of 512 (the chunked prefill, K3's tile body at Lq 16,
              then the token loop, its row body at Lq 1), launch counts
              zeroed just before and read just after; tokens/s, ms per
              token step and TTFT (the 1-token generate); then the first
              prefill chunk's and decode step's logits at 2 layers of full
              width, card against CPU, as phase 4 (c) holds them.

It prints the ``kernels`` JSON line and the card line before the last line,
which is ``{"ok": true, "device": {...}}``. ``--phases times,serving`` runs
only K2's and K3's value-form timings and phase 4, through the API that
earlier commits share: copied into an earlier checkout, the script measures
that commit the same way (no ``kernels`` line then). Details go to
``chiprun_out/chip_smoke_seed<N>.json``. It exits non-zero, printing no result, when
CUDA is unavailable or the package is missing.
"""

import argparse
import dataclasses
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and bf16 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

#: the kernels each main path must launch
SERVING_KERNELS = ("flash_fwd", "flash_decode", "quant_matmul")
SPARSE_KERNELS = ("sparse_fwd", "sparse_bwd")
TRAINING_KERNELS = ("flash_fwd", "flash_bwd")
MOE_TRAINING_KERNELS = ("flash_fwd", "flash_bwd", "moe_permute")

RESULTS = {"checks": [], "timings": {}}

#: the head dims each kernel takes on the card (K2 and K5 have none)
HEAD_DIMS = {"flash_fwd": [64, 128], "flash_bwd": [64, 128], "flash_decode": [64, 128],
             "quant_matmul": None, "moe_permute": None, "sparse_fwd": [64], "sparse_bwd": [64]}

#: the keys of each kernel in the ``kernels`` line (``launches`` is added);
#: ``device_ms``, the kernel's own device-side time, only where
#: ``library_ms`` is device-side too (K1, K4, K5, K6), so the two compare on
#: one clock
KERNEL_LINE_KEYS = ("name", "route", "source", "replaces", "max_abs_err", "ms", "device_ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, iters: int = 5, warmup: int = 2, attempts: int = 3) -> dict:
    """Device time per call of ``fn`` by kernel name: each kernel's time
    over ``iters`` calls under ``torch.profiler``, divided by ``iters``.
    Unlike events around host-issued calls (``time_ms``), launch gaps and
    host work between the kernels do not count. Profiling the CUDA
    activity alone sometimes came back with no device event at all on an
    H100, for a call whose kernels had just run; with the CPU activity
    beside it that was not seen. A profile with no device event is taken
    again all the same, up to ``attempts`` times in all."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events:
            return {e.key: e.self_device_time_total / 1e3 / iters for e in events}
        log(f"torch.profiler recorded no device time for {iters} calls; profiling again")
    raise AssertionError(f"torch.profiler recorded no device time in {attempts} profiles: the "
                         "device-side timing cannot be measured")


def short_name(key: str) -> str:
    """A profiler kernel name without its namespace and signature."""
    m = re.search(r"\w+_kernel", key)
    return m.group(0) if m else key


def device_ms(fn, **kw) -> float:
    """Device time per call of ``fn``, all its kernels summed."""
    return sum(device_times(fn, **kw).values())


def bound_ms(nbytes: float, flops: float, flop_rate: float = PEAK_BF16_FLOP_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, that over max |ref|), both in fp32."""
    got32, ref32 = got.float(), ref.float()
    err = (got32 - ref32).abs().max().item()
    return err, err / max(ref32.abs().max().item(), 1e-30)


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, dtype, tol: float = None) -> float:
    torch.cuda.synchronize()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs plain {tuple(ref.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    tol = TOL[dtype] if tol is None else tol
    err, rel = rel_err(got, ref)
    ok = rel <= tol
    RESULTS["checks"].append({"name": name, "max_abs_err": err, "rel_err": rel, "tol": tol, "ok": ok})
    log(f"check {name}: max_abs_err={err:.3e} rel={rel:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: relative error {rel:.3e} > {tol:.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
#: K3's cache length, and the lengths of the 8 slots it is timed at: the
#: serving mix of the timed decode tick, and one long slot beside 7 empty
P = 1024
K3_MIXES = {"serving mix": [0, 1, 37, 300, 517, 777, 1000, 1024],
            "one long slot": [1024, 0, 0, 0, 0, 0, 0, 0]}
#: K2's (K, N) on the serving path: GPT-2 350m's QKV, attention out, MLP in
#: and MLP out projections (M = 8 a decode tick, 128 a prefill tick)
K2_SHAPES = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))
#: bytes of weights the cold-L2 timings rotate through (the H100's L2 is 50 MB)
ROTATE_BYTES = 64 << 20


def k3_pool(gen, s: int, dtype, hh: int = 16, d: int = 64):
    """A random int8 KV pool [s, P, hh, d] (codes for k and v) and its
    per-(slot, position, head) scales in ``dtype``."""
    dev = torch.device("cuda")
    kc, vc = torch.randint(-127, 128, (2, s, P, hh, d), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
    ks, vs = (torch.rand(2, s, P, hh, 1, generator=gen, device=dev) * 0.05 + 1e-3).to(dtype)
    return kc, vc, ks, vs


def k3_pairs(lengths, lq: int) -> int:
    """(query row, live key) pairs of one head of a K3 call."""
    return sum(max(0, min(min(max(x, 0), P), x - lq + r + 1)) for x in lengths for r in range(lq))


def k2_operands(gen, m: int, kk: int, n: int, bits: int, dtype=torch.bfloat16):
    """Random K2 operands at group 64: x [m, kk], the codes as stored (int4
    packed), per-(group, column) scales, the unpacked codes and the group
    count."""
    from deepspeed_tpu_torch.ops.quantizer.core import divisor_groups
    from deepspeed_tpu_torch.ops.quantizer.weights import pack_rows
    dev = torch.device("cuda")
    g = divisor_groups(kk, 64)
    codes = torch.randint(-127 if bits == 8 else -7, 128 if bits == 8 else 8, (kk, n),
                          generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
    qw = codes if bits == 8 else pack_rows(codes)
    scale = (torch.rand(g, n, generator=gen, device=dev) * 0.02 + 1e-3).float()
    x = torch.randn(m, kk, generator=gen, device=dev).to(dtype)
    return x, qw, scale, codes, g


def rotating(make, nbytes: int):
    """Copies of an operand set, enough to exceed ``ROTATE_BYTES``, and a
    function that returns the next copy: a call timed over them finds its
    operands in device memory, not in the L2, as the served weights are."""
    copies = [make() for _ in range(max(2, -(-ROTATE_BYTES // nbytes)))]
    state = [0]

    def nxt():
        state[0] = (state[0] + 1) % len(copies)
        return copies[state[0]]

    return copies, nxt


def kernel_times(gen) -> dict:
    """K2 at every serving shape and K3's value form at Lq 1 and 16 over
    the two length mixes: the kernel's event-timed and device-side time,
    the plain version's and one library call's (device-side, event-timed
    beside it), and the bound. K2 and its library call (a bf16 matmul over
    the dequantised weight) are timed over rotating weight copies larger
    than the L2. Uses only the wrappers' value-form API, so the same code
    times an earlier commit's bodies (``--phases times``)."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import quant_matmul as qm
    dev = torch.device("cuda")
    out = {"quant_matmul": {}, "flash_decode": {}, "k3_ops": {}}
    for kk, n in K2_SHAPES:
        for m in (8, 128):
            for bits in (8, 4):
                x, qw, scale, codes, g = k2_operands(gen, m, kk, n, bits)
                w = (codes.float().reshape(g, kk // g, n) * scale[:, None, :]).reshape(kk, n).to(torch.bfloat16)
                copies, nxt = rotating(lambda: (qw.clone(), scale.clone(), w.clone()),
                                       qw.numel() + scale.numel() * 4)
                kernel = lambda: qm.quant_matmul(x, *nxt()[:2], bits=bits)  # noqa: E731
                library = lambda: torch.matmul(x, nxt()[2])  # noqa: E731
                dev_ms = device_ms(kernel, iters=len(copies))
                lib_ms = device_ms(library, iters=len(copies))
                ms = time_ms(kernel, iters=len(copies))
                lib_event_ms = time_ms(library, iters=len(copies))
                plain_ms = time_ms(lambda: qm.quant_matmul_plain(x, qw, scale, bits), iters=10)
                nbytes = m * kk * 2 + qw.numel() + scale.numel() * 4 + m * n * 2
                bnd, by = bound_ms(nbytes, 2 * m * kk * n)
                key = f"int{bits} M={m} K={kk} N={n}"
                out["quant_matmul"][key] = dict(
                    shape=f"x [{m},{kk}] bf16 @ int{bits} [{kk},{n}], scales [{g},{n}]", mkn_bits=(m, kk, n, bits),
                    ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                    library_event_ms=lib_event_ms, bound_ms=bnd, bound_by=by, rotated_copies=len(copies))
                log(f"time quant_matmul {key} (cold L2, {len(copies)} copies): kernel_ms={ms:.4f} "
                    f"kernel_device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                    f"(bf16 matmul over the dequantised weight, device-side; event-timed "
                    f"{lib_event_ms:.4f}) bound_ms={bnd:.4f} ({by})")
                del copies, kernel, library
    kpos = torch.arange(P, device=dev)
    for lq in (1, 16):
        for mix, lengths in K3_MIXES.items():
            q = torch.randn(8, lq, 16, 64, generator=gen, device=dev).to(torch.bfloat16)
            kc, vc, ks, vs = k3_pool(gen, 8, torch.bfloat16)
            k, v = kc.to(torch.bfloat16) * ks, vc.to(torch.bfloat16) * vs  # the dequantised pool
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            kernel = lambda: fa.flash_decode(q, k, v, lens)  # noqa: E731
            qpos = lens.long()[:, None] - lq + torch.arange(lq, device=dev)[None, :]  # [S, Lq]
            mask = ((kpos[None, None, :] <= qpos[:, :, None])
                    & (kpos[None, None, :] < lens.long().clamp(0, P)[:, None, None]))[:, None]
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
            live = sum(min(x, P) for x in lengths)
            nbytes = live * 16 * 64 * 2 * 2 + 2 * q.numel() * 2 + lens.numel() * 4
            bnd, by = bound_ms(nbytes, 4 * 64 * 16 * k3_pairs(lengths, lq))
            out["flash_decode"][f"Lq={lq} {mix} bf16"] = dict(
                shape=f"q [8,{lq},16,64], k/v [8,1024,16,64] bf16, lengths {lengths}",
                ms=time_ms(kernel, iters=50), device_ms=device_ms(kernel),
                plain_ms=time_ms(lambda: fa.flash_decode_plain(q, k, v, lens, scale=0.125), iters=5, warmup=1),
                library_ms=device_ms(sdpa), library_event_ms=time_ms(sdpa, iters=50), bound_ms=bnd, bound_by=by)
            out["k3_ops"][(lq, mix)] = dict(q=q, kc=kc, vc=vc, ks=ks, vs=vs, lens=lens)
    return out


def kernel_phase(gen: torch.Generator, seed: int):
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import quant_matmul as qm

    dev = torch.device("cuda")
    lines = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- K1 flash forward -----------------------------------------------------
    def k1(name, b, h, lq, lk, d, dtype, causal=True, kv_lengths=None, window=None):
        q, k, v = randn(b, lq, h, d, dtype=dtype), randn(b, lk, h, d, dtype=dtype), randn(b, lk, h, d, dtype=dtype)
        lens = None if kv_lengths is None else torch.tensor(kv_lengths, dtype=torch.int32, device=dev)
        scale = d**-0.5
        o, lse = fa.flash_fwd(q, k, v, scale=scale, causal=causal, kv_lengths=lens, window=window)
        ro, rlse = fa.flash_fwd_plain(q, k, v, scale=scale, causal=causal, kv_lengths=lens, window=window)
        err = compare(f"flash_fwd {name}", o, ro, dtype)
        live = rlse > -1e30
        if not torch.equal(live, lse > -1e30):
            raise AssertionError(f"flash_fwd {name}: rows with no live key differ")
        compare(f"flash_fwd {name} lse", lse[live], rlse[live], torch.float32 if dtype == torch.float32 else dtype)
        return q, k, v, err

    k1("[2,4,256,64] fp32 causal", 2, 4, 256, 256, 64, torch.float32)
    k1("[3,4,200,64] bf16 kv_lengths", 3, 4, 200, 200, 64, torch.bfloat16, causal=False,
       kv_lengths=[200, 77, 0])
    k1("[2,4,130,64] bf16 causal kv_lengths", 2, 4, 130, 130, 64, torch.bfloat16, kv_lengths=[130, 50])
    k1("[2,4,300,64] bf16 causal window=100", 2, 4, 300, 300, 64, torch.bfloat16, window=100)
    k1("[2,4,16,300,64] bf16 causal lq<lk", 2, 4, 16, 300, 64, torch.bfloat16)
    d = 64
    scale = d**-0.5
    k1_lines = {}
    for b, what in ((4, "serving forward"), (8, "training step")):
        q, k, v, err = k1(f"[{b},16,1024,64] bf16 causal", b, 16, 1024, 1024, 64, torch.bfloat16)
        h, l = 16, 1024
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(lambda: fa.flash_fwd(q, k, v, scale=scale, causal=True), iters=10)
        dev_ms = device_ms(lambda: fa.flash_fwd(q, k, v, scale=scale, causal=True))
        plain_ms = time_ms(lambda: fa.flash_fwd_plain(q, k, v, scale=scale, causal=True), iters=3, warmup=1)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
        lib_event_ms = time_ms(sdpa, iters=10)
        lib_ms = device_ms(sdpa)
        pairs = b * h * l * (l + 1) / 2
        bnd, by = bound_ms(4 * b * h * l * d * 2 + b * h * l * 4, 4 * d * pairs)
        k1_lines[b] = dict(name="flash_fwd", route="cuda", source="deepspeed_tpu_torch/csrc/flash_fwd.cu",
                           replaces="deepspeed_tpu/ops/pallas/flash_attention.py:117",
                           shape=f"q,k,v [{b},1024,16,64] bf16 causal ({what})", max_abs_err=err,
                           ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                           library_ms=lib_ms, library_event_ms=lib_event_ms)
    RESULTS["timings"]["flash_fwd"] = k1_lines
    lines["flash_fwd"] = k1_lines[8]

    # -- K4 flash backward: dq, dk, dv --------------------------------------
    def k4(name, b, h, lq, lk, d, dtype, causal=True, kv_lengths=None, window=None):
        if lq == lk:  # q, k, v as the model gives them: slices of the fused QKV output
            qkv = randn(b, lq, 3, h, d, dtype=dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = randn(b, lq, h, d, dtype=dtype), randn(b, lk, h, d, dtype=dtype), randn(b, lk, h, d, dtype=dtype)
        do = randn(b, lq, h, d, dtype=dtype)
        lens = None if kv_lengths is None else torch.tensor(kv_lengths, dtype=torch.int32, device=dev)
        kw = dict(scale=d**-0.5, causal=causal, kv_lengths=lens, window=window)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        got = fa.flash_bwd(q, k, v, o, lse, do, **kw)
        ref = fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
        errs = [compare(f"flash_bwd {name} d{x}", g, r, dtype) for x, g, r in zip("qkv", got, ref)]
        del ref
        return (q, k, v, o, lse, do), max(errs)

    (q, k, v, o, lse, do), err = k4("[8,1024,16,64] bf16 causal (fused QKV)", 8, 16, 1024, 1024, 64,
                                    torch.bfloat16)
    k4("[2,4,256,64] fp32 causal", 2, 4, 256, 256, 64, torch.float32)
    k4("[3,4,200,64] bf16 kv_lengths 200,77,0", 3, 4, 200, 200, 64, torch.bfloat16, causal=False,
       kv_lengths=[200, 77, 0])
    k4("[2,4,130,64] bf16 causal kv_lengths 130,50", 2, 4, 130, 130, 64, torch.bfloat16,
       kv_lengths=[130, 50])
    k4("[2,4,200,64] fp32 causal kv_lengths 0,70", 2, 4, 200, 200, 64, torch.float32, kv_lengths=[0, 70])
    k4("[2,4,300,64] bf16 causal window=100", 2, 4, 300, 300, 64, torch.bfloat16, window=100)
    k4("[2,4,16,300,64] bf16 causal lq<lk", 2, 4, 16, 300, 64, torch.bfloat16)
    k4_probe_err = exact_probes(seed)
    b, h, l = 8, 16, 1024
    kw = dict(scale=scale, causal=True)
    ms = time_ms(lambda: fa.flash_bwd(q, k, v, o, lse, do, **kw), iters=10)
    split = {short_name(name): t
             for name, t in device_times(lambda: fa.flash_bwd(q, k, v, o, lse, do, **kw)).items()}
    dev_ms = sum(split.values())
    log("K4 device ms by kernel: " + ", ".join(f"{name} {t:.4f}" for name, t in split.items()))
    plain_ms = time_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, **kw), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
    lib_event_ms = time_ms(sdpa_bwd, iters=10)
    lib_ms = device_ms(sdpa_bwd)
    del out, qt, kt, vt, dot, sdpa_bwd
    pairs = b * h * l * (l + 1) / 2
    # q, k, v, o, dO read and dq, dk, dv written once, plus lse; 5 products
    # (s, dp, dv, dk, dq) of 2 * D FLOPs per live pair
    bnd, by = bound_ms(8 * b * h * l * d * 2 + b * h * l * 4, 10 * d * pairs)
    lines["flash_bwd"] = dict(name="flash_bwd", route="cuda", source="deepspeed_tpu_torch/csrc/flash_bwd.cu",
                              replaces="deepspeed_tpu/ops/pallas/flash_attention.py:403",
                              shape="q,k,v,o,dO [8,1024,16,64] bf16 causal (training step)",
                              max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                              bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                              library_event_ms=lib_event_ms, device_ms_by_kernel=split,
                              exact_probe_max_abs_err=k4_probe_err)
    RESULTS["timings"]["flash_bwd"] = lines["flash_bwd"]

    # -- K3 flash decode: the value and int8 forms, Lq 1 and 16 --------------
    def k3(name, lq, lengths, dtype, d=64, hh=16):
        q = randn(len(lengths), lq, hh, d, dtype=dtype)
        kc, vc, ks, vs = k3_pool(gen, len(lengths), dtype)
        k, v = fa.dequantize_kv(kc, ks, dtype), fa.dequantize_kv(vc, vs, dtype)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        o = fa.flash_decode(q, k, v, lens)
        err = compare(f"flash_decode {name} values", o, fa.flash_decode_plain(q, k, v, lens, scale=d**-0.5),
                      dtype)
        o8 = fa.flash_decode(q, kc, vc, lens, k_scale=ks, v_scale=vs)
        err8 = compare(f"flash_decode {name} int8", o8,
                       fa.flash_decode_plain(q, kc, vc, lens, scale=d**-0.5, k_scale=ks, v_scale=vs), dtype)
        compare_exact(f"flash_decode {name}: int8 form = value form on the dequantised pool", o8, o)
        return err, err8

    k3("S=8 Lq=16 P=1024 bf16 lengths 0,1,P,P+Lq", 16, [0, 1, 15, 16, 300, 1000, P, P + 16], torch.bfloat16)
    k3("S=8 Lq=1 P=1024 bf16 lengths 0,1,P,P+Lq", 1, [0, 1, 2, 64, 65, 1000, P, P + 1], torch.bfloat16)
    k3("S=4 Lq=16 P=1024 fp32", 16, [5, 16, 700, P + 16], torch.float32)
    k3("S=4 Lq=1 P=1024 fp32", 1, [5, 16, 700, P + 1], torch.float32)
    k3_errs = {(lq, mix): k3(f"S=8 Lq={lq} P=1024 bf16 {mix}", lq, lengths, torch.bfloat16)
               for lq in (1, 16) for mix, lengths in K3_MIXES.items()}
    k3_probe_err = decode_exact_probes(seed)

    # -- K2 quant matmul: every body against its plain version --------------
    def k2(m, kk, n, bits, dtype=torch.bfloat16):
        x, qw, scale, _, g = k2_operands(gen, m, kk, n, bits, dtype)
        body = qm.qmm_body(m, kk, n, kk // g, dtype == torch.bfloat16, True)
        return compare(f"quant_matmul int{bits} M={m} K={kk} N={n} {str(dtype)[6:]} ({body} body)",
                       qm.quant_matmul(x, qw, scale, bits=bits), qm.quant_matmul_plain(x, qw, scale, bits),
                       dtype)

    k2_errs = {(m, kk, n, bits): k2(m, kk, n, bits) for kk, n in K2_SHAPES for m in (8, 128) for bits in (8, 4)}
    for m, kk, n, bits in ((1, 1024, 1024, 8), (16, 1024, 3072, 4), (17, 1024, 3072, 8),
                           (130, 4096, 1024, 8), (130, 1024, 1024, 4), (16, 320, 272, 8)):
        k2(m, kk, n, bits)
    k2(128, 1024, 3072, 8, torch.float32)
    k2(8, 4096, 1024, 4, torch.float32)
    k2(8, 96, 40, 8)  # N not a multiple of 16: the general body in bf16
    k2_probe_err = quant_matmul_probes(seed)

    # -- K2 and K3 times -------------------------------------------------------
    times = kernel_times(gen)
    for key, t in times["quant_matmul"].items():
        m, kk, n, bits = t["mkn_bits"]
        t["max_abs_err"] = k2_errs[(m, kk, n, bits)]
    for (lq, mix), (err, err8) in k3_errs.items():
        ops = times["k3_ops"][(lq, mix)]
        lengths, q, lens = K3_MIXES[mix], ops["q"], ops["lens"]
        times["flash_decode"][f"Lq={lq} {mix} bf16"]["max_abs_err"] = err
        kw = dict(k_scale=ops["ks"], v_scale=ops["vs"])
        int8 = lambda: fa.flash_decode(q, ops["kc"], ops["vc"], lens, **kw)  # noqa: E731
        deq = lambda: (fa.dequantize_kv(ops["kc"], ops["ks"], torch.bfloat16),  # noqa: E731
                       fa.dequantize_kv(ops["vc"], ops["vs"], torch.bfloat16))
        live = sum(min(x, P) for x in lengths)
        # codes (1 byte) and a bf16 scale per live key, head and operand, q read, o written
        nbytes = live * 16 * (64 + 2) * 2 + 2 * q.numel() * 2 + lens.numel() * 4
        bnd, by = bound_ms(nbytes, 4 * 64 * 16 * k3_pairs(lengths, lq))
        values = times["flash_decode"][f"Lq={lq} {mix} bf16"]
        times["flash_decode"][f"Lq={lq} {mix} int8"] = dict(
            shape=f"q [8,{lq},16,64] bf16, k/v [8,1024,16,64] int8 + bf16 scales, lengths {lengths}",
            max_abs_err=err8, ms=time_ms(int8, iters=50), device_ms=device_ms(int8),
            plain_ms=time_ms(lambda: fa.flash_decode_plain(q, ops["kc"], ops["vc"], lens, scale=0.125, **kw),
                             iters=5, warmup=1),
            library_ms=values["library_ms"], library_event_ms=values["library_event_ms"],
            dequantise_ms=device_ms(deq), bound_ms=bnd, bound_by=by)
    del times["k3_ops"]
    RESULTS["timings"]["quant_matmul"] = times["quant_matmul"]
    RESULTS["timings"]["flash_decode"] = times["flash_decode"]
    for key, t in times["flash_decode"].items():
        log(f"time flash_decode {key}: kernel_ms={t['ms']:.4f} kernel_device_ms={t['device_ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} (masked SDPA, device-side; "
            f"event-timed {t['library_event_ms']:.4f})"
            + (f" dequantise_ms={t['dequantise_ms']:.4f}" if "dequantise_ms" in t else "")
            + f" bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
    lines["flash_decode"] = dict(name="flash_decode", route="cuda",
                                 source="deepspeed_tpu_torch/csrc/flash_decode.cu",
                                 replaces="deepspeed_tpu/ops/pallas/flash_attention.py:555",
                                 exact_probe_max_abs_err=k3_probe_err,
                                 **times["flash_decode"]["Lq=1 serving mix int8"])
    lines["quant_matmul"] = dict(name="quant_matmul", route="cuda",
                                 source="deepspeed_tpu_torch/csrc/quant_matmul.cu",
                                 replaces="deepspeed_tpu/ops/pallas/quant_matmul.py:74",
                                 exact_probe_max_abs_err=k2_probe_err,
                                 **times["quant_matmul"]["int8 M=8 K=1024 N=4096"])
    lines["moe_permute"] = k5_cases(gen)
    lines.update(k6_cases(gen, seed))
    for ln in (k1_lines[4], k1_lines[8], lines["flash_bwd"], lines["moe_permute"],
               lines["sparse_fwd"], lines["sparse_bwd"]):
        log_time(ln)
    return lines


def log_time(ln: dict) -> None:
    """One kernel's times; where measured, the device-side kernel and
    library times (profiler sums) beside the event-timed ones."""
    extra = ""
    if "device_ms" in ln:
        extra += f" kernel_device_ms={ln['device_ms']:.4f}"
    if "library_event_ms" in ln:
        extra += f" (library device-side; event-timed {ln['library_event_ms']:.4f})"
    log(f"time {ln['name']} {ln['shape']}: kernel_ms={ln['ms']:.4f}{extra} "
        f"plain_ms={ln['plain_ms']:.4f} library_ms={ln['library_ms']:.4f} "
        f"bound_ms={ln['bound_ms']:.4f} ({ln['bound_by']})")


def compare_exact(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """A copy kernel against its plain version: equal bit for bit."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs plain "
                             f"{tuple(ref.shape)} {ref.dtype}")
    err = (got.float() - ref.float()).abs().max().item() if got.numel() else 0.0
    ok = torch.equal(got, ref)
    RESULTS["checks"].append({"name": name, "max_abs_err": err, "tol": 0.0, "ok": ok})
    log(f"check {name}: max_abs_err={err:.3e} tol=0 (exact) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: differs from the plain version (max |err| {err:.3e})")
    return err


#: exact-probe shapes of K1 and K4 (``deepspeed_tpu_torch.testing.exact_probe``):
#: lq, lk, causal, kv_lengths, window
PROBES = ((100, 100, True, None, None), (16, 130, True, None, None),
          (64, 64, False, [64, 9, 0], None), (200, 200, True, None, 33),
          (96, 160, True, [160, 100, 0], 100), (300, 300, True, None, 100))


def exact_probes(seed: int, head_dim: int = 64) -> float:
    """K1 and K4 in bf16 on inputs whose result is exact (one-hot softmax
    rows, small-integer v and dO, dead decoy keys past the mask boundaries):
    o, lse, dq, dk and dv each within 1e-6 of the known answer (dq = dk =
    0). Returns the largest |error|."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.testing import exact_probe
    worst = 0.0
    for lq, lk, causal, lens, window in PROBES:
        p = exact_probe(3, lq, lk, 4, causal=causal, kv_lengths=lens, window=window, seed=seed,
                        dtype=torch.bfloat16, device="cuda", head_dim=head_dim)
        kw = dict(scale=p["scale"], causal=causal, kv_lengths=p["kv_lengths"], window=window)
        o, lse = fa.flash_fwd(p["q"], p["k"], p["v"], **kw)
        got = dict(zip(("dq", "dk", "dv"), fa.flash_bwd(p["q"], p["k"], p["v"], o, lse, p["do"], **kw)),
                   o=o, lse=lse)
        torch.cuda.synchronize()
        for name, g in got.items():
            want = p[name].float()
            err = (g.float() - want).abs().max().item()
            tol = 1e-6 * max(1.0, want.abs().max().item())
            ok = err <= tol
            what = (f"exact probe [3,{lq},{lk},4,{head_dim}] bf16 causal={causal} kv_lengths={lens} "
                    f"window={window} {name}")
            RESULTS["checks"].append({"name": what, "max_abs_err": err, "tol": tol, "ok": ok})
            log(f"check {what}: max_abs_err={err:.3e} tol={tol:.1e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{what}: |err| {err:.3e} > {tol:.1e}")
            worst = max(worst, err)
    return worst


def decode_exact_probes(seed: int, head_dim: int = 64) -> float:
    """K3 in bf16 and fp32, in both operand forms, at Lq 1 and 16, on inputs
    whose output is exact (one-hot softmax rows, with a dead decoy key just
    past each live range, or in the next slot past a full pool, that would
    win if read: ``deepspeed_tpu_torch.testing.decode_exact_probe``): o
    within 1e-6 of the known answer, 0 where no key is live. Returns the
    largest |error|."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.testing import decode_exact_probe
    worst = 0.0
    for lq, lengths in ((1, [0, 1, 64, 65, 129, 255, 256, 257]), (16, [0, 1, 15, 16, 100, 256, 272, 250])):
        for part in (lengths[:4], lengths[4:]):
            for dtype in (torch.bfloat16, torch.float32):
                p = decode_exact_probe(part, lq, 256, 16, seed=seed, dtype=dtype, device="cuda",
                                       head_dim=head_dim)
                for form in ("values", "int8"):
                    if form == "values":
                        o = fa.flash_decode(p["q"], p["k"], p["v"], p["lengths"], scale=p["scale"])
                    else:
                        o = fa.flash_decode(p["q"], p["k_codes"], p["v_codes"], p["lengths"], scale=p["scale"],
                                            k_scale=p["k_scale"], v_scale=p["v_scale"])
                    torch.cuda.synchronize()
                    err = (o.float() - p["o"].float()).abs().max().item()
                    tol = 1e-6 * max(1.0, p["o"].float().abs().max().item())
                    ok = err <= tol
                    what = (f"exact probe flash_decode [4,{lq},16,{head_dim}] P=256 {str(dtype)[6:]} {form} "
                            f"lengths {part}")
                    RESULTS["checks"].append({"name": what, "max_abs_err": err, "tol": tol, "ok": ok})
                    log(f"check {what}: max_abs_err={err:.3e} tol={tol:.1e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{what}: |err| {err:.3e} > {tol:.1e}")
                    worst = max(worst, err)
    return worst


def quant_matmul_probes(seed: int) -> float:
    """K2's three bodies (decode M = 8, prefill M = 128, the general body in
    fp32), int8 and int4, on inputs where every summation order gives the
    same bits (``deepspeed_tpu_torch.testing.quant_matmul_probe``): integer
    x, the codes' whole range, power-of-two scales (the integer probe) and
    scales whose products are not bf16 values (the probe that sees a bf16
    weight left unrounded before the product). Kernel and plain version
    must agree bit for bit. Returns the largest |error| (0)."""
    from deepspeed_tpu_torch.ops.cuda import quant_matmul as qm
    from deepspeed_tpu_torch.testing import quant_matmul_probe
    worst = 0.0
    for bits in (8, 4):
        for m in (8, 128):
            for dtype in (torch.bfloat16, torch.float32):
                for round_scales in (False, True):
                    p = quant_matmul_probe(m, 1024, 3072, bits, round_scales=round_scales, seed=seed + m + bits,
                                           dtype=dtype, device="cuda")
                    body = qm.qmm_body(m, 1024, 3072, 64, dtype == torch.bfloat16, True)
                    what = (f"exact probe quant_matmul int{bits} M={m} K=1024 N=3072 {str(dtype)[6:]} ({body} body) "
                            f"{'rounding' if round_scales else 'integer'} scales")
                    worst = max(worst, compare_exact(what, qm.quant_matmul(p["x"], p["qw"], p["scale"], bits=bits),
                                                     qm.quant_matmul_plain(p["x"], p["qw"], p["scale"], bits)))
    return worst


def routed_maps(gen, groups: int, tokens: int, experts: int, capacity: int):
    """The sorted route's index maps for random top-1 routing of ``tokens``
    tokens per group: ``(flat_slot [G, S], src [G, E*C])`` int32, tokens past
    an expert's capacity parked on the sentinel E*C."""
    from deepspeed_tpu_torch.ops.cuda.moe_dispatch import inverse_index
    expert = torch.randint(0, experts, (groups, tokens), generator=gen, device="cuda")
    pos = (torch.cumsum(F.one_hot(expert, experts), dim=1) - 1).gather(2, expert[..., None])[..., 0]
    flat = torch.where(pos < capacity, expert * capacity + pos, experts * capacity).to(torch.int32)
    return flat, inverse_index(flat, experts * capacity)


def k5_cases(gen) -> dict:
    """K5 at the MoE step's shapes (S = 8 x 1024 tokens, E = 8, C = 1280,
    M = 1024): dispatch [1,8192,1024] -> [1,10240,1024] and combine back, in
    bf16 and fp32, a quarter of sentinel rows, and two groups; forward and
    VJP (``PermuteRows``' backward, K5 on the inverse map) against the plain
    gather and its autograd, exactly. Times dispatch and combine in bf16,
    each launch reading one of three copies of the input so that no launch
    finds its input in the 50 MB L2 cache: K5 and ``index_select`` over the
    same rows device-side (``torch.profiler``), the event-timed figures
    beside them."""
    import itertools

    from deepspeed_tpu_torch.moe.sharded_moe import _gate_capacity
    from deepspeed_tpu_torch.ops.cuda import moe_dispatch as md

    S, E, M = 8192, 8, 1024
    C = _gate_capacity(S, E, 1.25, 4, True, 1)
    flat, src = routed_maps(gen, 1, S, E, C)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def case(name, x, fwd, bwd):
        err = compare_exact(f"moe_permute {name}", md.moe_permute(x, fwd), md.moe_permute_plain(x, fwd))
        cot = randn(x.shape[0], fwd.shape[1], x.shape[2], dtype=x.dtype)
        xk = x.detach().requires_grad_()
        (gk,) = torch.autograd.grad(md.permute_rows(xk, fwd, bwd, impl="pallas"), xk, cot)
        xp = x.detach().requires_grad_()
        (gp,) = torch.autograd.grad(md.permute_rows(xp, fwd, bwd, impl="xla"), xp, cot)
        return max(err, compare_exact(f"moe_permute {name} VJP", gk, gp))

    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        t = str(dtype)[6:]
        errs.append(case(f"dispatch [1,{S},{M}]->[1,{E * C},{M}] {t}", randn(1, S, M, dtype=dtype),
                         src, flat))
        errs.append(case(f"combine [1,{E * C},{M}]->[1,{S},{M}] {t}", randn(1, E * C, M, dtype=dtype),
                         flat, src))
    idx = torch.randperm(E * C, generator=gen, device="cuda")[None]
    idx = torch.where((torch.rand(idx.shape, generator=gen, device="cuda") < 0.25) | (idx >= S),
                      S + 7, idx).to(torch.int32)
    errs.append(case(f"quarter sentinels [1,{S},{M}]->[1,{E * C},{M}] bf16",
                     randn(1, S, M, dtype=torch.bfloat16), idx, md.inverse_index(idx, S)))
    c2 = _gate_capacity(S // 2, E, 1.25, 4, True, 1)
    flat2, src2 = routed_maps(gen, 2, S // 2, E, c2)
    errs.append(case(f"G=2 dispatch [2,{S // 2},{M}] bf16", randn(2, S // 2, M, dtype=torch.bfloat16),
                     src2, flat2))
    errs.append(case(f"G=2 combine [2,{E * c2},{M}] bf16", randn(2, E * c2, M, dtype=torch.bfloat16),
                     flat2, src2))

    timed = {}
    for what, n_rows, fwd in (("dispatch", S, src), ("combine", E * C, flat)):
        copies = [randn(1, n_rows, M, dtype=torch.bfloat16) for _ in range(3)]
        nxt = itertools.cycle(copies).__next__
        clamped = fwd[0].clamp(max=n_rows - 1).long()
        kernel = lambda: md.moe_permute(nxt(), fwd)  # noqa: E731
        library = lambda: torch.index_select(nxt()[0], 0, clamped)  # noqa: E731
        ms = time_ms(kernel, iters=60)
        dev_ms = device_ms(kernel, iters=30)
        plain_ms = time_ms(lambda: md.moe_permute_plain(nxt(), fwd), iters=30)
        lib_event_ms = time_ms(library, iters=60)
        lib_ms = device_ms(library, iters=30)
        live = int((fwd < n_rows).sum())
        r = fwd.shape[1]
        # live source rows read once, every output row written, the index read
        bnd, by = bound_ms(live * M * 2 + r * M * 2 + r * 4, 0.0)
        shape = (f"x [1,{n_rows},{M}] bf16 -> [1,{r},{M}], {live} live rows "
                 f"({what}, S={S} E={E} C={C})")
        timed[what] = dict(name="moe_permute", route="cuda",
                           source="deepspeed_tpu_torch/csrc/moe_permute.cu",
                           replaces="deepspeed_tpu/ops/pallas/moe_dispatch.py:76", shape=shape,
                           max_abs_err=max(errs), ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                           library_event_ms=lib_event_ms)
        log(f"time moe_permute {shape}: kernel_ms={ms:.4f} kernel_device_ms={dev_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (index_select of the clamped "
            f"index, no zeroing; device-side; event-timed {lib_event_ms:.4f}) "
            f"bound_ms={bnd:.4f} ({by})")
    RESULTS["timings"]["moe_permute"] = timed
    return timed["dispatch"]


def sparse_configs(seed: int) -> dict:
    """The sparse slice's two layouts: name -> (config, [B, L, H, D], causal).
    (a) Sparse Transformer "fixed" (Child et al. 2019, upstream DeepSpeed's
    FixedSparsityConfig defaults), unidirectional, at GPT-2 350m's training
    attention shape; (b) BigBird ITC (Zaheer et al. 2020: block 64, r=3,
    w=3, g=2) with a layout per head, at 4096 tokens."""
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig, FixedSparsityConfig
    return {
        "fixed": (FixedSparsityConfig(num_heads=16, block=16, num_local_blocks=4, num_global_blocks=1,
                                      attention="unidirectional"), (8, 1024, 16, 64), True),
        "bigbird": (BigBirdSparsityConfig(num_heads=16, block=64, num_random_blocks=3,
                                          num_sliding_window_blocks=3, num_global_blocks=2,
                                          attention="bidirectional", different_layout_per_head=True,
                                          seed=seed), (2, 4096, 16, 64), False),
    }


def live_pairs(layout, block: int, causal: bool) -> int:
    """(query, key) pairs a layout makes live in one batch row, the diagonal
    blocks' causal halves counted exactly."""
    layout = np.asarray(layout, bool)
    if not causal:
        return int(layout.sum()) * block * block
    n = layout.shape[1]
    below = int((layout & np.tril(np.ones((n, n), bool), -1)).sum())
    diag = int((layout & np.eye(n, dtype=bool)).sum())
    return below * block * block + diag * block * (block + 1) // 2


def layout_mask(layout, block: int, causal: bool) -> torch.Tensor:
    """[1, H, L, L] bool of a layout's live pairs on the card: the
    ``attn_mask`` of the library call K6 is timed against."""
    m = torch.as_tensor(np.asarray(layout, bool), device="cuda")
    m = m.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        m = m & torch.ones(m.shape[1:], dtype=torch.bool, device="cuda").tril()
    return m[None]


def edge_layout(rng, h: int, n: int) -> np.ndarray:
    """Per-head random layouts that hold K6's edge cases: query block 1
    reads nothing, query block 2 only the last block (above the diagonal:
    empty under causal), and key block n - 2 is read by no query block."""
    layout = (rng.random((h, n, n)) < 0.35).astype(np.int64)
    layout[:, np.arange(n), np.arange(n)] = 1
    layout[:, 1, :] = 0
    layout[:, 2, :] = 0
    layout[:, 2, n - 1] = 1
    layout[:, :, n - 2] = 0
    return layout


def k6_check(name, q, k, v, do, lists, causal: bool, block: int, dtype):
    """K6 forward and backward against their plain versions on the same
    inputs. Returns ((o, lse), forward max |err|, backward max |err|)."""
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    kw = dict(scale=q.shape[-1]**-0.5, causal=causal, block=block)
    o, lse = sa.sparse_fwd(q, k, v, *lists[:2], **kw)
    ro, rlse = sa.sparse_fwd_plain(q, k, v, *lists[:2], **kw)
    err_f = compare(f"sparse_fwd {name}", o, ro, dtype)
    live = rlse > -1e30
    if not torch.equal(live, lse > -1e30):
        raise AssertionError(f"sparse_fwd {name}: rows with no live key differ")
    if live.any():
        compare(f"sparse_fwd {name} lse", lse[live], rlse[live],
                torch.float32 if dtype == torch.float32 else dtype)
    del ro, rlse
    got = sa.sparse_bwd(q, k, v, o, lse, do, *lists, **kw)
    ref = sa.sparse_bwd_plain(q, k, v, o, lse, do, *lists, **kw)
    err_b = max(compare(f"sparse_bwd {name} d{x}", g, r, dtype) for x, g, r in zip("qkv", got, ref))
    return (o, lse), err_f, err_b


#: K6 exact-probe shapes (``deepspeed_tpu_torch.testing.sparse_exact_probe``): block,
#: length, 3 heads (at 80 rows the last thread block holds 3 of its 4 list groups)
SPARSE_PROBES = ((16, 512), (64, 1024), (16, 80))


def sparse_exact_probes(seed: int) -> float:
    """K6 on inputs whose result is exact (one-hot rows over a random
    per-head layout, dead decoys in left-out blocks and past the diagonal),
    bf16 and fp32, blocks 16 and 64, causal and not, in the longest-first
    launch order: o, lse, dq, dk and dv each within 1e-6 of the known
    answer. Returns the largest |error|."""
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (index_lists_on,
                                                                               launch_orders_on)
    from deepspeed_tpu_torch.testing import sparse_exact_probe
    worst = 0.0
    for block, l in SPARSE_PROBES:
        for causal in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                p = sparse_exact_probe(2, l, 3, block, causal=causal, seed=seed, dtype=dtype,
                                       device="cuda")
                lists = index_lists_on(p["layout"], "cuda")
                q_order, k_order = launch_orders_on(p["layout"], block, "cuda")
                kw = dict(scale=p["scale"], causal=causal, block=block)
                o, lse = sa.sparse_fwd(p["q"], p["k"], p["v"], *lists[:2], order=q_order, **kw)
                grads = sa.sparse_bwd(p["q"], p["k"], p["v"], o, lse, p["do"], *lists,
                                      q_order=q_order, k_order=k_order, **kw)
                got = dict(zip(("dq", "dk", "dv"), grads), o=o, lse=lse)
                torch.cuda.synchronize()
                for name, g in got.items():
                    want = p[name].float()
                    err = (g.float() - want).abs().max().item()
                    tol = 1e-6 * max(1.0, want.abs().max().item())
                    ok = err <= tol
                    what = (f"sparse exact probe [2,{l},3,64] block {block} {str(dtype)[6:]} "
                            f"causal={causal} {name}")
                    RESULTS["checks"].append({"name": what, "max_abs_err": err, "tol": tol, "ok": ok})
                    log(f"check {what}: max_abs_err={err:.3e} tol={tol:.1e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{what}: |err| {err:.3e} > {tol:.1e}")
                    worst = max(worst, err)
    return worst


def kernel_symbol(mangled: str) -> str:
    """``dkdv_kernel<f,32>`` from its Itanium-mangled symbol: the last name
    of the nested name and its template arguments (numbers, builtin type
    letters, names)."""
    rest, name = mangled[3:] if mangled.startswith("_ZN") else mangled, mangled
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group(0)
        name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    if not rest.startswith("I"):
        return name
    args, rest = [], rest[1:]
    while rest and rest[0] != "E":
        m = re.match(r"Li(\d+)E|(\d+)|([a-z])", rest)
        if not m:
            break
        if m.group(2):
            n = int(m.group(2))
            args.append(rest[len(m.group(2)):len(m.group(2)) + n])
            rest = rest[len(m.group(2)) + n:]
            continue
        args.append(m.group(1) or m.group(3))
        rest = rest[m.end():]
    return f"{name}<{','.join(args)}>"


def sass_stats(name: str) -> dict:
    """Per kernel function of library ``name``: registers and local-memory
    bytes (where spills land) from ``cuobjdump -res-usage``, and the HMMA
    (tensor-core mma) and atomic (ATOM, ATOMS, ATOMG, RED) instructions in
    its SASS from ``cuobjdump -sass``."""
    from deepspeed_tpu_torch.ops.cuda import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    lib = str(build.library_path(name))
    stats, fn = {}, None
    for line in subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True, check=True,
                               timeout=120).stdout.splitlines():
        m = re.search(r"Function (\S+?):?\s*$", line)
        if m:
            fn = kernel_symbol(m.group(1))
        m = re.search(r"REG:(\d+).*LOCAL:(\d+)", line)
        if m and fn:
            stats[fn] = {"registers": int(m.group(1)), "local_bytes": int(m.group(2)), "hmma": 0,
                         "atomics": 0}
    for line in subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                               timeout=120).stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_symbol(m.group(1))
            stats.setdefault(fn, {"hmma": 0, "atomics": 0})
        elif fn and re.search(r"\bHMMA\b", line):
            stats[fn]["hmma"] += 1
        elif fn and re.search(r"\b(ATOM|ATOMS|ATOMG|RED)\b", line):
            stats[fn]["atomics"] += 1
    return stats


def k6_cases(gen, seed: int) -> dict:
    """K6 against its plain versions for every block the kernel takes (16,
    32, 64, 128) on per-head layouts with an empty row, a row above the
    diagonal and a dead key block, fp32 and bf16, causal and not, q/k/v and
    dO strided; the exact probes; then at the sparse slice's two shapes in
    bf16, where it times the kernels (event-timed, and device-side by
    kernel: forward, delta, dq, dk/dv) in the longest-first launch order
    and in natural order, their plain versions and SDPA with the layout
    expanded to a boolean mask (its output checked against the kernel's),
    and computes the bound from the layout's live pairs."""
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (index_lists_on,
                                                                               launch_orders_on)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    rng = np.random.default_rng(seed)
    for block in (16, 32, 64, 128):
        h, n = 4, 8
        l = n * block
        lists = index_lists_on(edge_layout(rng, h, n), "cuda")
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                qkv = randn(2, l, 3, h, 64, dtype=dtype)
                do = randn(2, l, h, 2, 64, dtype=dtype)[:, :, :, 0]
                k6_check(f"[2,{l},{h},64] block {block} {str(dtype)[6:]} causal={causal} (edge layout)",
                         qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do, lists, causal, block, dtype)
    probe_err = sparse_exact_probes(seed)

    timed = {}
    for name, (cfg, (b, l, h, d), causal) in sparse_configs(seed).items():
        layout = cfg.make_layout(l)
        block = cfg.block
        lists = index_lists_on(layout, "cuda")
        q_order, k_order = launch_orders_on(layout, block, "cuda")
        q, k, v, do = (randn(b, l, h, d) for _ in range(4))
        shape = f"q,k,v [{b},{l},{h},{d}] bf16, {name} layout block {block}{' causal' if causal else ''}"
        (o, lse), err_f, err_b = k6_check(shape, q, k, v, do, lists, causal, block, torch.bfloat16)
        kw = dict(scale=d**-0.5, causal=causal, block=block)
        orders = {"longest_first": dict(order=q_order, q_order=q_order, k_order=k_order),
                  "natural": dict(order=None, q_order=None, k_order=None)}

        def fwd(order):
            return lambda: sa.sparse_fwd(q, k, v, *lists[:2], order=order["order"], **kw)

        def bwd(order):
            return lambda: sa.sparse_bwd(q, k, v, o, lse, do, *lists, q_order=order["q_order"],
                                         k_order=order["k_order"], **kw)

        by_order = {}
        for which in ("longest_first", "natural", "natural", "longest_first"):  # in turns
            order = orders[which]
            split = {short_name(kn): t for kn, t in device_times(fwd(order)).items()}
            split.update({short_name(kn): t for kn, t in device_times(bwd(order)).items()})
            for kn, t in split.items():
                by_order.setdefault(which, {}).setdefault(kn, []).append(t)
        fwd_ms = time_ms(fwd(orders["longest_first"]), iters=10)
        bwd_ms = time_ms(bwd(orders["longest_first"]), iters=10)
        best = {w: {kn: min(ts) for kn, ts in split.items()} for w, split in by_order.items()}
        fwd_dev = best["longest_first"]["sparse_fwd_mma_kernel"]
        bwd_split = {kn: t for kn, t in best["longest_first"].items() if kn != "sparse_fwd_mma_kernel"}
        bwd_dev = sum(bwd_split.values())
        log(f"K6 {name} device ms by kernel (min of 2 profiles each, in turns): "
            + "; ".join(f"{w}: " + ", ".join(f"{kn} {t:.4f}" for kn, t in split.items())
                        for w, split in best.items()))
        fwd_plain = time_ms(lambda: sa.sparse_fwd_plain(q, k, v, *lists[:2], **kw), iters=3, warmup=1)
        bwd_plain = time_ms(lambda: sa.sparse_bwd_plain(q, k, v, o, lse, do, *lists, **kw), iters=3,
                            warmup=1)
        mask = layout_mask(layout, block, causal)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        compare(f"sparse_fwd {shape} vs SDPA with the layout mask", o, lib.transpose(1, 2), torch.bfloat16)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
        fwd_lib_event, fwd_lib = time_ms(sdpa, iters=10), device_ms(sdpa)
        qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        dot = do.transpose(1, 2).contiguous()
        sdpa_bwd = lambda: torch.autograd.grad(lib, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
        bwd_lib_event, bwd_lib = time_ms(sdpa_bwd, iters=10), device_ms(sdpa_bwd)
        del lib, qt, kt, vt, dot, mask, sdpa, sdpa_bwd
        pairs = b * live_pairs(layout, block, causal)
        elem = b * l * h * d * 2
        # q, k, v, o (and dO, dq, dk, dv) once and lse; 4 D FLOPs per live
        # pair forward (s, pv), 10 D backward (s, dp, dv, dk, dq)
        f_bnd, f_by = bound_ms(4 * elem + b * h * l * 4, 4 * d * pairs)
        b_bnd, b_by = bound_ms(8 * elem + b * h * l * 4, 10 * d * pairs)
        common = dict(route="cuda", shape=shape)
        timed[name] = {
            "live_pairs": pairs, "active_blocks_per_row": float(np.asarray(layout, bool).sum(-1).mean()),
            "device_ms_by_order": best,
            "sparse_fwd": dict(name="sparse_fwd", source="deepspeed_tpu_torch/csrc/sparse_fwd.cu",
                               replaces="deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py:54",
                               max_abs_err=err_f, ms=fwd_ms, device_ms=fwd_dev,
                               plain_ms=fwd_plain, bound_ms=f_bnd,
                               bound_by=f_by, library_ms=fwd_lib, library_event_ms=fwd_lib_event,
                               exact_probe_max_abs_err=probe_err, **common),
            "sparse_bwd": dict(name="sparse_bwd", source="deepspeed_tpu_torch/csrc/sparse_bwd.cu",
                               replaces="deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py:171",
                               max_abs_err=err_b, ms=bwd_ms, device_ms=bwd_dev,
                               plain_ms=bwd_plain, bound_ms=b_bnd,
                               bound_by=b_by, library_ms=bwd_lib, library_event_ms=bwd_lib_event,
                               device_ms_by_kernel=bwd_split, exact_probe_max_abs_err=probe_err,
                               **common)}
        log(f"sparse layout {name}: {pairs} live pairs, {timed[name]['active_blocks_per_row']:.2f} "
            f"active blocks per query block of {l // block}")
        if name != "fixed":
            for ln in (timed[name]["sparse_fwd"], timed[name]["sparse_bwd"]):
                log_time(ln)
        del o, lse
    for lib_name in SPARSE_KERNELS:
        stats = sass_stats(lib_name)
        RESULTS.setdefault("sass", {})[lib_name] = stats
        log(f"{lib_name} registers / local bytes / HMMA / atomics by kernel: " + "; ".join(
            f"{fn} {st.get('registers')} / {st.get('local_bytes')} / {st['hmma']} / {st['atomics']}"
            for fn, st in sorted(stats.items())))
        mma = {fn: st for fn, st in stats.items() if "mma_kernel" in fn}
        if len(mma) < 4 or not all(st["hmma"] > 0 for st in mma.values()):
            raise AssertionError(f"{lib_name}: a bf16 kernel without HMMA instructions: {mma}")
        if any(st["atomics"] for st in stats.values()):
            raise AssertionError(f"{lib_name}: atomic instructions in the SASS: {stats}")
    RESULTS["timings"]["sparse_attention"] = timed
    return {k: timed["fixed"][k] for k in SPARSE_KERNELS}


# ---------------------------------------------------------------------------
# phase 4: the serving slice at full width
# ---------------------------------------------------------------------------
def _copy_module(module, device, dtype):
    """The served model rebuilt on ``device`` with activations in ``dtype``:
    the same int8 codes and scales, float weights cast. On the CPU every
    kernel wrapper computes its plain version."""
    cfg = dataclasses.replace(module.config, dtype=dtype, param_dtype=dtype)
    copy = type(module)(cfg, device=device)
    copy.load_state_dict({k: v.to(device=device, dtype=dtype if v.is_floating_point()
                                  and not k.endswith("_scale") else v.dtype)
                          for k, v in module.state_dict().items()}, strict=True)
    return copy


def _two_ticks(module, ids, device, kv_quant):
    """Run the first prefill tick (every slot's first ``ids`` chunk from
    position 0) through ``module``. Returns (its logits, a function that runs
    the next decode tick on given tokens, the tick's seconds)."""
    from deepspeed_tpu_torch.inference.serving.programs import (make_apply_fn, make_slot_cache,
                                                                stamp_lengths)
    apply_fn = make_apply_fn(module)
    cache = make_slot_cache(module, ids.shape[0], kv_quant=kv_quant)
    zeros = np.zeros(ids.shape[0], np.int64)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    prefill = apply_fn(stamp_lengths(cache, zeros), ids.to(device))
    sync()
    t1 = time.perf_counter()
    return prefill, (lambda tokens: apply_fn(stamp_lengths(cache, zeros + ids.shape[1]),
                                             tokens[:, None].to(device))), t1 - t0


def device_events(prof) -> list:
    """The profile's kernels: device-side events with device time, without
    the device ranges of user annotations (``Optimizer.step`` records one),
    which would count their kernels twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


#: kernel families of the training step's profile, by name
TRAIN_KERNEL_FAMILIES = (("K1 flash_fwd", ("flash_fwd_mma_kernel", "flash_fwd_kernel")),
                         ("K4 flash_bwd", ("dkdv_mma_kernel", "dq_mma_kernel", "dkdv_kernel",
                                           "dq_kernel", "delta_kernel")),
                         ("K5 moe_permute", ("permute_kernel<",)),
                         ("GEMM (cuBLAS/CUTLASS)", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
                         ("sort and scan (MoE gate)", ("Sort", "sort", "Scan", "scan")))

#: the MoE layer's profiler ranges (forward and remat recompute) and the
#: PyTorch ops whose device time the MoE step reports on their own
MOE_RANGES = ("moe_gate", "moe_dispatch", "moe_experts", "moe_combine")
MOE_OPS = ("aten::bmm", "aten::sort", "aten::cumsum", "aten::scatter_", "aten::index_add_",
           "aten::one_hot", "aten::mm")


#: kernel families of the serving ticks' profile, by kernel name (the
#: bodies of earlier commits too, so a parent profiles the same way)
SERVE_KERNEL_FAMILIES = (("K2 quant_matmul", ("qmm_gemv_kernel", "qmm_mma_kernel", "qmm_fma_kernel",
                                              "quant_matmul_kernel", "reduce_splits_kernel")),
                         ("K3 flash_decode", ("decode_rows_kernel", "decode_tile_kernel",
                                              "flash_decode_kernel")))


def tick_split(prof, events, n_ticks: int, pool_shape) -> dict:
    """Device ms per tick of K2, K3, the int8 KV pool's dequantise pass (the
    pool-shaped copy to bf16 and multiply by the scales that ran before K3
    until K3 read the codes itself: the CPU ops ``aten::copy_`` and
    ``aten::mul`` on a pool-shaped first operand, by their own kernels) and
    everything else."""
    split = {name: 0.0 for name, _ in SERVE_KERNEL_FAMILIES}
    for e in events:
        for name, keys in SERVE_KERNEL_FAMILIES:
            if any(key in e.key for key in keys):
                split[name] += e.self_device_time_total
                break
    split["KV dequantise"] = sum(e.self_device_time_total for e in prof.key_averages(group_by_input_shape=True)
                                 if e.key in ("aten::copy_", "aten::mul") and e.input_shapes
                                 and list(e.input_shapes[0]) == list(pool_shape))
    split["rest"] = sum(e.self_device_time_total for e in events) - sum(split.values())
    return {name: t / 1e3 / n_ticks for name, t in split.items()}


def _tick_window(sched, kind: str, n_ticks: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        if sched.step() != kind:
            raise AssertionError(f"timed window left the steady {kind} state")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_ticks


def _profile_ticks(sched, kind: str, n_ticks: int, card: str, pool_shape) -> dict:
    """``n_ticks`` ticks of ``kind`` on the wall clock, then ``n_ticks`` more
    under ``torch.profiler``: the device's busy time per tick (the
    device-side events only: a CPU op's device time repeats its kernels'),
    split by kernel family (:func:`tick_split`), its idle share of the
    unprofiled tick, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    wall_ms = _tick_window(sched, kind, n_ticks)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        profiled_wall_ms = _tick_window(sched, kind, n_ticks)
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n_ticks
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    result = {"ticks": n_ticks, "wall_ms_per_tick": wall_ms,
              "profiled_wall_ms_per_tick": profiled_wall_ms,
              "device_busy_ms_per_tick": busy_ms if events else None,
              "device_idle_share": 1.0 - busy_ms / wall_ms if events else None,
              "busy_ms_per_tick_by_kernel": tick_split(prof, events, n_ticks, pool_shape) if events else None,
              "top_kernels": [{"name": e.key[:90], "calls_per_tick": e.count / n_ticks,
                               "device_ms_per_tick": e.self_device_time_total / 1e3 / n_ticks}
                              for e in top]}
    if not events:
        log(f"profile: no device time recorded by torch.profiler; device busy share not measured "
            f"(wall {wall_ms:.2f} ms/tick)  [{card}]")
        return result
    log(f"profile of {n_ticks} {kind} ticks (8 slots): wall {wall_ms:.2f} ms/tick "
        f"({profiled_wall_ms:.2f} under the profiler), device busy {busy_ms:.2f} ms/tick, "
        f"idle share {result['device_idle_share']:.3f}  [{card}]")
    log(f"  {kind} tick busy ms by kernel: " + ", ".join(
        f"{name} {t:.3f}" for name, t in result["busy_ms_per_tick_by_kernel"].items()))
    for k in result["top_kernels"]:
        log(f"  {k['device_ms_per_tick']:.3f} ms/tick, {k['calls_per_tick']:.0f} calls/tick: {k['name']}")
    return result


def _profile_prefill_ticks(sched, rng, vocab: int, card: str, pool_shape, n_ticks: int = 5) -> dict:
    """Where a prefill tick's time goes: 8 requests whose prompts take
    ``2 n_ticks + 2`` chunks fill every slot, so every tick of both windows
    prefills all 8 (M = 128 rows through K2, Lq = 16 through K3); they are
    then served to the end (one new token each)."""
    from deepspeed_tpu_torch.inference.serving import Request
    length = sched.config.prefill_chunk * (2 * n_ticks + 2)
    for _ in range(sched.slots):
        sched.submit(Request(rng.integers(0, vocab, size=length).astype(np.int32), max_new_tokens=1))
    if sched.step() != "prefill":
        raise AssertionError("the prefill window did not start with a prefill tick")
    torch.cuda.synchronize()
    result = _profile_ticks(sched, "prefill", n_ticks, card, pool_shape)
    sched.run_until_drained()
    return result


def _profile_decode_ticks(sched, prompts, card, pool_shape, n_ticks: int = 10) -> dict:
    """Where a steady decode tick's time goes: 8 requests are prefilled,
    then :func:`_profile_ticks` over decode ticks. The requests are then
    served to the end."""
    from deepspeed_tpu_torch.inference.serving import ACTIVE, Request

    # a short prompt decodes while a long one still prefills: its budget
    # must outlast every prefill tick, or it finishes before the windows
    chunk = sched.config.prefill_chunk
    budget = 2 * n_ticks + 2 + sum(-(-len(p) // chunk) for p in prompts)
    reqs = [sched.submit(Request(p, max_new_tokens=budget)) for p in prompts]
    while not all(r.state == ACTIVE for r in reqs):
        sched.step()
    torch.cuda.synchronize()
    result = _profile_ticks(sched, "decode", n_ticks, card, pool_shape)
    sched.run_until_drained()
    return result


def slice_phase(seed: int, card: str):
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
    from deepspeed_tpu_torch.inference.serving import (FINISHED, ContinuousBatchingScheduler,
                                                       Request, ServingConfig)
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = get_gpt2_config("350m", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = GPT2LMHeadModel(cfg, device="cuda", generator=gen)
    engine = init_inference(model, dtype="bf16", kernel_inject=True, use_flash_prefill=True)
    del model
    if engine.module.config.attention_backend != "flash":
        raise AssertionError("kernel injection did not select the flash backend")
    scfg = ServingConfig(slots=8, prefill_chunk=16, kv_quant=True, weight_dtype="int8")
    sched = ContinuousBatchingScheduler(engine, scfg)
    sched.warmup()
    rng = np.random.default_rng(seed)
    prompt_lens = rng.integers(32, 257, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(p)).astype(np.int32) for p in prompt_lens]
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4, 1024)), device="cuda")
    gen_prompts = rng.integers(0, cfg.vocab_size, size=(2, 64))
    torch.cuda.synchronize()

    # ---- the main path: counts zeroed just before, read just after ----
    reset_launches()
    t0 = time.perf_counter()
    logits = engine.forward(tokens)
    torch.cuda.synchronize()
    out["forward_s"] = time.perf_counter() - t0
    if logits.shape != (4, 1024, cfg.vocab_size) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"forward: bad logits {tuple(logits.shape)}")
    del logits
    t0 = time.perf_counter()
    generated = engine.generate(gen_prompts, max_new_tokens=32)
    out["generate_s"] = time.perf_counter() - t0
    if tuple(generated.shape) != (2, 64 + 32) or not (generated[:, :64].numpy() == gen_prompts).all():
        raise AssertionError(f"generate: bad output {tuple(generated.shape)}")
    requests = [Request(p, max_new_tokens=32) for p in prompts]
    t0 = time.perf_counter()
    sched.serve(requests)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = launches()
    # ---- end of the main path ----

    stats = sched.stats()
    if not all(r.state == FINISHED and len(r.output) == 32 for r in requests):
        raise AssertionError("not every request finished with 32 tokens")
    if stats["pool"]["used_blocks"] != 0 or stats["pool"]["total_frees"] != 16:
        raise AssertionError(f"block pool did not return to empty: {stats['pool']}")
    missing = [k for k in SERVING_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing} ({counts})")
    ticks = sum(stats["ticks"].values())
    out.update(serve_s=serve_s, ticks=stats["ticks"], launches=counts,
               generated_tokens=stats["generated_tokens"],
               tokens_per_s=stats["generated_tokens"] / serve_s, ms_per_tick=serve_s / ticks * 1e3,
               ttft=stats["ttft"], per_token=stats["per_token"])
    log(f"slice (a) forward [4,1024]: {out['forward_s']:.3f} s; generate 2x32: "
        f"{out['generate_s']:.3f} s  [{card}]")
    log(f"slice (b) served 16/16 requests, {stats['generated_tokens']} tokens in {serve_s:.3f} s: "
        f"{out['tokens_per_s']:.1f} tokens/s, {out['ms_per_tick']:.2f} ms/tick over {ticks} ticks "
        f"{stats['ticks']}  [{card}]")
    log(f"slice launches on the main path: {counts}")

    pool_shape = (scfg.slots, sched.capacity, cfg.n_head, cfg.n_embd // cfg.n_head)
    out["prefill_profile"] = _profile_prefill_ticks(sched, rng, cfg.vocab_size, card, pool_shape)
    out["profile"] = _profile_decode_ticks(sched, prompts[:8], card, pool_shape)

    # ---- (c) the first prefill and decode ticks against the plain versions ----
    # Both in fp32 with an fp KV cache, held to 1e-4: there neither bf16
    # rounding nor an int8 KV code that rounds the other way on one side
    # drowns a kernel fault, so this is the comparison that fails a kernel.
    # The served model as is (bf16, int8 KV, CUDA kernels) against the same
    # model on the CPU (plain versions): random weights make the 24 layers
    # amplify every 1-ulp difference, so this sits at bf16's own error and is
    # held to 1.5x that error as this run measures it (plain bf16 with int8
    # KV against plain fp32 with an fp KV cache), not to a fixed limit.
    ids = torch.as_tensor(np.stack([p[:16] for p in prompts[:8]]).astype(np.int64))
    cpu = torch.device("cpu")
    runs = {}
    for name, device, dtype in (("served_bf16", torch.device("cuda"), torch.bfloat16),
                                ("plain_bf16", cpu, torch.bfloat16),
                                ("served_fp32", torch.device("cuda"), torch.float32),
                                ("plain_fp32", cpu, torch.float32)):
        module = sched.module if name == "served_bf16" else _copy_module(sched.module, device, dtype)
        runs[name] = _two_ticks(module, ids, device, kv_quant=dtype == torch.bfloat16)
    nxt = runs["served_bf16"][0][:, -1].argmax(-1).cpu()
    t0 = time.perf_counter()
    decode = {"served_bf16": runs["served_bf16"][1](nxt)}
    torch.cuda.synchronize()
    decode_tick_s = time.perf_counter() - t0
    for name in ("plain_bf16", "served_fp32", "plain_fp32"):
        decode[name] = runs[name][1](nxt)
    prefill = {name: run[0].cpu() for name, run in runs.items()}
    decode = {name: d.cpu() for name, d in decode.items()}
    for tick, logits in (("prefill", prefill), ("decode", decode)):
        compare(f"slice {tick} tick logits fp32 (served vs plain)", logits["served_fp32"],
                logits["plain_fp32"], torch.float32)
        for name in ("served_bf16", "plain_bf16"):
            rel = rel_err(logits[name], logits["plain_fp32"])[1]
            out[f"{tick}_{name}_vs_plain_fp32_rel"] = rel
            log(f"slice {tick} tick {name} (int8 KV) vs plain_fp32 (fp KV): rel={rel:.3e}")
        rounding = out[f"{tick}_plain_bf16_vs_plain_fp32_rel"]
        compare(f"slice {tick} tick logits bf16 (served vs plain, 1.5x rounding)",
                logits["served_bf16"], logits["plain_bf16"], torch.bfloat16, tol=1.5 * rounding)
    agree_prefill = (prefill["served_bf16"][:, -1].argmax(-1)
                     == prefill["plain_bf16"][:, -1].argmax(-1)).float().mean().item()
    agree_decode = (decode["served_bf16"][:, -1].argmax(-1)
                    == decode["plain_bf16"][:, -1].argmax(-1)).float().mean().item()
    prefill_tick_s = runs["served_bf16"][2]
    out.update(greedy_agreement_prefill=agree_prefill, greedy_agreement_decode=agree_decode,
               prefill_tick_ms=prefill_tick_s * 1e3, decode_tick_ms=decode_tick_s * 1e3)
    log(f"slice (c) greedy-token agreement served vs plain (bf16): prefill {agree_prefill:.3f}, "
        f"decode {agree_decode:.3f}; one prefill tick {prefill_tick_s * 1e3:.2f} ms, one decode "
        f"tick {decode_tick_s * 1e3:.2f} ms  [{card}]")
    return out, counts


# ---------------------------------------------------------------------------
# phases 5 and 6: the training slice at full width, and its gradients
# ---------------------------------------------------------------------------
def flops_per_token(n_params: int, n_layers: int, hidden: int, seq: int, causal: bool = True) -> float:
    """Training FLOPs per token as the JAX package's bench counts them
    (``tools/bench_core.py:20-32``): 6 N for the parameter products plus the
    attention scores, 12 L s E, halved when causal."""
    attn = 12.0 * n_layers * hidden * seq
    if causal:
        attn /= 2.0
    return 6.0 * n_params + attn


def train_config(micro: int, clip: float, bf16: bool) -> dict:
    """The JAX bench's engine config (``bench.py:107-114``), ZeRO 0 on one card."""
    return {"train_batch_size": micro, "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
            "bf16": {"enabled": bf16}, "gradient_clipping": clip,
            "zero_optimization": {"stage": 0}, "steps_per_print": 10**9}


def _profile_train_step(engine, batch, card, step_ms: float) -> dict:
    """Device time of one steady training step, from the device-side events
    of ``torch.profiler`` only (a CPU op's device time repeats its
    kernels'), against the unprofiled step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    # device time of the kernels each CPU-side range or op launched, its
    # children's included (aten::bmm: the expert GEMMs, forward, recompute
    # and backward; the moe_* ranges: forward and recompute only)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and (e.name in MOE_RANGES or e.name in MOE_OPS):
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3, calls + 1)
    families = {}
    for e in events:
        family = next((f for f, keys in TRAIN_KERNEL_FAMILIES if any(k in e.key for k in keys)),
                      "other (elementwise, reductions, copies)")
        families[family] = families.get(family, 0.0) + e.self_device_time_total / 1e3
    result = {"wall_ms_per_step": step_ms, "profiled_wall_ms": profiled_ms,
              "device_busy_ms_per_step": busy_ms if events else None,
              "device_idle_share": 1.0 - busy_ms / step_ms if events else None,
              "device_ms_by_family": families,
              "device_ms_by_range_or_op": {k: {"device_ms": ms, "calls": c}
                                           for k, (ms, c) in by_name.items()},
              "top_kernels": [{"name": e.key[:90], "calls": e.count,
                               "device_ms": e.self_device_time_total / 1e3} for e in top]}
    if not events:
        log(f"train profile: no device time recorded by torch.profiler; busy share not measured  [{card}]")
        return result
    log(f"train profile of one step: wall {step_ms:.2f} ms ({profiled_ms:.2f} under the profiler), "
        f"device busy {busy_ms:.2f} ms, idle share {result['device_idle_share']:.3f}  [{card}]")
    log("  by family: " + ", ".join(f"{f} {ms:.2f} ms" for f, ms in
                                    sorted(families.items(), key=lambda kv: -kv[1])))
    if by_name:
        log("  by range or op (device ms of what it launched, calls): " + ", ".join(
            f"{k} {ms:.2f} ms/{c}" for k, (ms, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])))
    for k in result["top_kernels"]:
        log(f"  {k['device_ms']:.3f} ms, {k['calls']} calls: {k['name']}")
    return result


def train_phase(seed: int, card: str, warmup: int = 2, steps: int = 10):
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, initialize
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches

    micro, seq = 8, 1024
    cfg = get_gpt2_config("350m", vocab_size=50304, n_positions=seq, remat=True,
                          attention_backend="flash", dtype=torch.bfloat16, fused_head_loss_chunk=1024)
    model = GPT2LMHeadModel(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    engine, _, _, _ = initialize(model=model, config=train_config(micro, 1.0, True))
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (micro, seq)).astype(np.int32)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts zeroed just before, read just after ----
    reset_launches()
    losses = [engine.train_batch(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [engine.train_batch(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launches()
    # ---- end of the main path ----

    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: losses not finite and falling: {losses}")
    per_step = {k: c / (warmup + steps) for k, c in counts.items()}
    missing = [k for k in TRAINING_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the training path: {missing} ({counts})")
    if per_step["flash_fwd"] != 2 * cfg.n_layer or per_step["flash_bwd"] != cfg.n_layer:
        raise AssertionError(f"training: expected K1 twice (forward, remat recompute) and K4 once "
                             f"per layer per step, got {per_step}")
    step_ms = dt / steps * 1e3
    tokens_s = micro * seq * steps / dt
    fpt = flops_per_token(n_params, cfg.n_layer, cfg.n_embd, seq)
    out = dict(n_params=n_params, losses=losses, launches=counts, launches_per_step=per_step,
               step_ms=step_ms, tokens_per_s=tokens_s, model_tflops=fpt * tokens_s / 1e12,
               flops_per_token=fpt, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               grad_norm=engine.get_global_grad_norm())
    log(f"train: GPT-2 350m ({n_params} params), seq {seq}, micro-batch {micro}, bf16, remat, fused "
        f"head, flash; losses {losses[0]:.4f} -> {losses[-1]:.4f} over {warmup}+{steps} steps  [{card}]")
    log(f"train: {step_ms:.2f} ms/step, {tokens_s:.1f} tokens/s, {out['model_tflops']:.2f} model TFLOP/s "
        f"({fpt:.4g} FLOP/token), peak memory {out['peak_memory_gb']:.2f} GB  [{card}]")
    log(f"train launches on the main path: {counts}; per step {per_step}  [{card}]")
    out["profile"] = _profile_train_step(engine, batch, card, step_ms)
    return out, counts


def gradcheck(label: str, build, state: dict, ids: np.ndarray) -> dict:
    """One training step (no clipping) of the model ``build(device,
    dtype)`` with weights ``state`` on ``ids``, on the card and on the CPU,
    where every kernel wrapper computes its plain version: the loss and
    each parameter's gradient held to 1e-4 in fp32; in bf16 the largest
    relative error over those tensors is held to 1.5x the same largest
    error of plain bf16 against plain fp32."""
    from deepspeed_tpu_torch import initialize

    def one_step(device: str, dtype) -> dict:
        model = build(device, dtype)
        model.load_state_dict(state, strict=True)
        engine, _, _, _ = initialize(model=model, config=train_config(ids.shape[0], 0.0, dtype == torch.bfloat16),
                                     device=device)
        loss = engine.train_batch({"input_ids": ids})
        out = {"loss": loss.detach().float().cpu().reshape(1)}
        out.update({name: p.grad.detach().float().cpu() for name, p in model.named_parameters()})
        return out

    runs = {(dev, str(dt)[6:]): one_step(dev, dt) for dt in (torch.float32, torch.bfloat16)
            for dev in ("cuda", "cpu")}
    for name, ref in runs[("cpu", "float32")].items():
        compare(f"{label} fp32 {name} (card vs plain)", runs[("cuda", "float32")][name], ref,
                torch.float32)
    served = {n: rel_err(g, runs[("cpu", "bfloat16")][n])[1] for n, g in runs[("cuda", "bfloat16")].items()}
    rounding = {n: rel_err(g, runs[("cpu", "float32")][n])[1] for n, g in runs[("cpu", "bfloat16")].items()}
    worst = max(served, key=served.get)
    out = {"bf16_served_vs_plain_max_rel": served[worst], "bf16_served_worst_tensor": worst,
           "bf16_rounding_max_rel": max(rounding.values()),
           "loss": {f"{d}_{t}": float(r["loss"]) for (d, t), r in runs.items()}}
    out["bf16_share_of_limit"] = served[worst] / (1.5 * out["bf16_rounding_max_rel"])
    log(f"{label} bf16: card vs plain max rel {served[worst]:.3e} ({worst}); plain bf16 vs plain "
        f"fp32 max rel {out['bf16_rounding_max_rel']:.3e}; {out['bf16_share_of_limit']:.3f} of the "
        f"1.5x-rounding limit; losses {out['loss']}")
    if not served[worst] <= 1.5 * out["bf16_rounding_max_rel"]:
        raise AssertionError(f"{label} bf16: {served[worst]:.3e} > 1.5 x rounding "
                             f"{out['bf16_rounding_max_rel']:.3e}")
    RESULTS["checks"].append({"name": f"{label} bf16 (1.5x rounding)", "rel_err": served[worst],
                              "tol": 1.5 * out["bf16_rounding_max_rel"], "ok": True})
    return out


def gradcheck_phase(seed: int, card: str) -> dict:
    """One training step of GPT-2 350m's width at 2 layers, seq 512, batch
    2 (:func:`gradcheck`)."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config

    kw = dict(n_layer=2, vocab_size=50304, n_positions=512, remat=True, attention_backend="flash",
              fused_head_loss_chunk=1024)
    base = GPT2LMHeadModel(get_gpt2_config("350m", **kw), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    state = {k: v.detach().cpu() for k, v in base.state_dict().items()}
    del base
    ids = np.random.default_rng(seed + 1).integers(0, 50304, (2, 512)).astype(np.int32)
    return gradcheck("gradcheck", lambda device, dtype: GPT2LMHeadModel(
        get_gpt2_config("350m", dtype=dtype, **kw), device=device), state, ids)


def active_params(n_params: int, cfg) -> int:
    """Parameters that compute per token (``tools/bench_core.py:35-58``,
    copied, GPT-2 family): each MoE layer's E - k unused experts are left
    out, 8 E^2 + 5 E parameters each."""
    if not cfg.moe_num_experts:
        return n_params
    ffn = 8 * cfg.n_embd * cfg.n_embd + 5 * cfg.n_embd
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layer))
    return n_params - moe_layers * (cfg.moe_num_experts - cfg.moe_k) * ffn


def moe_train_phase(seed: int, card: str, warmup: int = 2, steps: int = 10):
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, initialize
    from deepspeed_tpu_torch.moe.sharded_moe import _gate_capacity
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches

    micro, seq = 8, 1024
    cfg = get_gpt2_config("350m", vocab_size=50304, n_positions=seq, remat=True,
                          attention_backend="flash", dtype=torch.bfloat16, fused_head_loss_chunk=1024,
                          moe_num_experts=8, moe_layer_freq=2, moe_k=1)
    model = GPT2LMHeadModel(cfg, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(seed + 2))
    engine, _, _, _ = initialize(model=model, config=train_config(micro, 1.0, True))
    n_params = sum(p.numel() for p in model.parameters())
    n_active = active_params(n_params, cfg)
    moe_layers = [i for i in range(cfg.n_layer) if cfg.is_moe_layer(i)]
    capacity = _gate_capacity(micro * seq, cfg.moe_num_experts, cfg.moe_capacity_factor,
                              cfg.moe_min_capacity, cfg.moe_drop_tokens, cfg.moe_k)
    rng = np.random.default_rng(seed + 2)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (micro, seq)).astype(np.int32)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts zeroed just before, read just after ----
    reset_launches()
    losses = [engine.train_batch(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [engine.train_batch(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launches()
    # ---- end of the main path ----

    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE training: losses not finite and falling: {losses}")
    per_step = {k: c / (warmup + steps) for k, c in counts.items()}
    missing = [k for k in MOE_TRAINING_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the MoE training path: {missing} ({counts})")
    want = {"flash_fwd": 2 * cfg.n_layer, "flash_bwd": cfg.n_layer, "moe_permute": 6 * len(moe_layers)}
    if any(per_step[k] != v for k, v in want.items()):
        raise AssertionError(f"MoE training: expected per step {want}, got {per_step}")
    kept = [int(model.blocks[i].moe.deepspeed_moe.kept_counts.sum()) for i in moe_layers]
    step_ms = dt / steps * 1e3
    tokens_s = micro * seq * steps / dt
    fpt = flops_per_token(n_active, cfg.n_layer, cfg.n_embd, seq)
    out = dict(n_params=n_params, n_active_params=n_active, moe_layers=moe_layers, capacity=capacity,
               kept_tokens_last_step=kept, losses=losses, launches=counts, launches_per_step=per_step,
               step_ms=step_ms, tokens_per_s=tokens_s, model_tflops=fpt * tokens_s / 1e12,
               flops_per_token=fpt, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               grad_norm=engine.get_global_grad_norm())
    log(f"moe train: GPT-2 350m + 8 experts every other layer ({n_params} params, {n_active} active), "
        f"top-1, capacity {capacity}, sorted route, seq {seq}, micro-batch {micro}, bf16, remat, "
        f"fused head, flash; losses {losses[0]:.4f} -> {losses[-1]:.4f} over {warmup}+{steps} "
        f"steps; tokens kept per MoE layer in the last step {kept} of {micro * seq}  [{card}]")
    log(f"moe train: {step_ms:.2f} ms/step, {tokens_s:.1f} tokens/s, {out['model_tflops']:.2f} model "
        f"TFLOP/s by active parameters ({fpt:.4g} FLOP/token), peak memory "
        f"{out['peak_memory_gb']:.2f} GB  [{card}]")
    log(f"moe train launches on the main path: {counts}; per step {per_step}  [{card}]")
    out["profile"] = _profile_train_step(engine, batch, card, step_ms)
    return out, counts, engine, batch


def moe_gradcheck_phase(seed: int, card: str) -> dict:
    """One training step of a 2-layer MoE model at 350m width (layer 1 MoE,
    8 experts, top-1, no RTS: routing depends on the data alone) on the card
    and on the CPU (plain versions). fp32: every token's expert, slot and
    keep identical, the loss and each gradient within 1e-4. bf16: the card's
    step runs under the plain bf16 step's routing, injected at the gate's
    output (``deepspeed_tpu_torch.testing.injected_routing``), and its
    largest relative error against the plain bf16 step is held within 1.5x
    the rounding the same run measures under that same routing (plain bf16
    against plain fp32 with the routing injected). A token that a bf16 ulp
    routes apart moves a lightly loaded expert's gradient by its whole
    share, beyond what any rounding yardstick covers; with the routing held
    fixed, the check reads the kernels' arithmetic. The free-routing
    comparison's share of the limit and the routing flips of both sides are
    printed and kept, not gated."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, initialize
    from deepspeed_tpu_torch.testing import injected_routing

    kw = dict(n_layer=2, vocab_size=50304, n_positions=512, remat=True, attention_backend="flash",
              fused_head_loss_chunk=1024, moe_num_experts=8, moe_layer_freq=2, moe_k=1,
              moe_use_rts=False)
    base = GPT2LMHeadModel(get_gpt2_config("350m", **kw), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(seed + 3))
    state = {k: v.detach().cpu() for k, v in base.state_dict().items()}
    del base
    ids = np.random.default_rng(seed + 3).integers(0, 50304, (2, 512)).astype(np.int32)

    def one_step(device: str, dtype, routing=None):
        model = GPT2LMHeadModel(get_gpt2_config("350m", dtype=dtype, **kw), device=device)
        model.load_state_dict(state, strict=True)
        engine, _, _, _ = initialize(model=model, config=train_config(2, 0.0, dtype == torch.bfloat16),
                                     device=device)
        with injected_routing(routing):
            loss = engine.train_batch({"input_ids": ids})
        out = {"loss": loss.detach().float().cpu().reshape(1)}
        out.update({name: p.grad.detach().float().cpu() for name, p in model.named_parameters()})
        used = model.h_1.moe.deepspeed_moe.last_routing  # [1, S, 1]: one token group
        return out, type(used)(*(t[0].cpu() for t in used))

    runs = {(dev, str(dt)[6:]): one_step(dev, dt) for dt in (torch.float32, torch.bfloat16)
            for dev in ("cuda", "cpu")}
    for f in ("expert", "slot", "keep"):
        got, ref = getattr(runs[("cuda", "float32")][1], f), getattr(runs[("cpu", "float32")][1], f)
        if not torch.equal(got, ref):
            raise AssertionError(f"moe gradcheck fp32: routing field {f} differs in "
                                 f"{int((got != ref).sum())} token copies")
    RESULTS["checks"].append({"name": "moe gradcheck fp32 routing identical", "ok": True})
    for name, ref in runs[("cpu", "float32")][0].items():
        compare(f"moe gradcheck fp32 {name} (card vs plain)", runs[("cuda", "float32")][0][name], ref,
                torch.float32)

    def flips(a, b):
        return int((a[1].expert != b[1].expert).sum())

    def worst_share(card_run, plain_bf16, plain_fp32):
        served = {n: rel_err(g, plain_bf16[0][n])[1] for n, g in card_run[0].items()}
        rounding = max(rel_err(g, plain_fp32[0][n])[1] for n, g in plain_bf16[0].items())
        worst = max(served, key=served.get)
        return worst, served[worst], rounding

    # the gate: the card's bf16 step and the plain fp32 yardstick under the
    # plain bf16 step's routing
    fixed = runs[("cpu", "bfloat16")][1]
    injected = {("cuda", "bfloat16"): one_step("cuda", torch.bfloat16, fixed),
                ("cpu", "float32"): one_step("cpu", torch.float32, fixed)}
    if any(flips(r, runs[("cpu", "bfloat16")]) for r in injected.values()):
        raise AssertionError("moe gradcheck bf16: the injected routing was not followed")
    worst, served, rounding = worst_share(injected[("cuda", "bfloat16")], runs[("cpu", "bfloat16")],
                                          injected[("cpu", "float32")])
    free_worst, free_served, free_rounding = worst_share(
        runs[("cuda", "bfloat16")], runs[("cpu", "bfloat16")], runs[("cpu", "float32")])
    out = {"bf16_served_vs_plain_max_rel": served, "bf16_served_worst_tensor": worst,
           "bf16_rounding_max_rel": rounding, "bf16_share_of_limit": served / (1.5 * rounding),
           "free_routing": {
               "bf16_served_vs_plain_max_rel": free_served, "bf16_served_worst_tensor": free_worst,
               "bf16_rounding_max_rel": free_rounding,
               "bf16_share_of_limit": free_served / (1.5 * free_rounding),
               "bf16_routing_flips_card_vs_plain": flips(runs[("cuda", "bfloat16")],
                                                         runs[("cpu", "bfloat16")]),
               "bf16_routing_flips_plain_bf16_vs_fp32": flips(runs[("cpu", "bfloat16")],
                                                              runs[("cpu", "float32")])},
           "tokens": int(ids.size),
           "loss": {f"{d}_{t}": float(r[0]["loss"]) for (d, t), r in runs.items()},
           "loss_injected": {f"{d}_{t}": float(r[0]["loss"]) for (d, t), r in injected.items()}}
    fr = out["free_routing"]
    log(f"moe gradcheck fp32: routing identical over {ids.size} tokens; bf16 under the plain bf16 "
        f"routing: card vs plain max rel {served:.3e} ({worst}), {out['bf16_share_of_limit']:.3f} of "
        f"the 1.5x-rounding limit (plain bf16 vs plain fp32 max rel {rounding:.3e}); free routing "
        f"(not gated): {free_served:.3e} ({free_worst}), {fr['bf16_share_of_limit']:.3f} of its limit "
        f"({free_rounding:.3e}), routing flips card vs plain (bf16) "
        f"{fr['bf16_routing_flips_card_vs_plain']}, plain bf16 vs fp32 "
        f"{fr['bf16_routing_flips_plain_bf16_vs_fp32']}; losses {out['loss']}  [{card}]")
    if not served <= 1.5 * rounding:
        raise AssertionError(f"moe gradcheck bf16 (injected routing): {served:.3e} > 1.5 x rounding "
                             f"{rounding:.3e}")
    RESULTS["checks"].append({"name": "moe gradcheck bf16 under one routing (1.5x rounding)",
                              "rel_err": served, "tol": 1.5 * rounding, "ok": True})
    return out


# ---------------------------------------------------------------------------
# phase 9: block-sparse attention through its public surface
# ---------------------------------------------------------------------------
def _leaves(*xs):
    return tuple(x.detach().clone().requires_grad_() for x in xs)


def _plain_path(lists, block: int, q, k, v, cot, causal: bool):
    """The path's plain versions on the same inputs: o, then dq, dk, dv."""
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    kw = dict(scale=q.shape[-1]**-0.5, causal=causal, block=block)
    with torch.no_grad():
        o, lse = sa.sparse_fwd_plain(q, k, v, *lists[:2], **kw)
        return (o,) + sa.sparse_bwd_plain(q, k, v, o, lse, cot, *lists, **kw)


def _compare_path(name, got, ref, dtype) -> float:
    return max(compare(f"{name} {x}", g, r, dtype) for x, g, r in zip(("o", "dq", "dk", "dv"), got, ref))


def _host_ms(fn, n: int = 50) -> float:
    """Host time per call of ``fn``: the loop is timed before the device is
    waited for (each call launches at most four kernels, so the launch
    queue never fills and blocks the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def _profile_sparse(run, step, name: str, lists, orders, card: str, iters: int = 5) -> dict:
    """Where one iteration of the sparse path spends its time, after the
    counted run: its kernels' device time and the device's idle share
    against the unprofiled wall time (``torch.profiler``), and the host
    time of its parts, unprofiled: the module's forward (no graph
    recorded), K6's backward wrapper alone, and the whole iteration, whose
    rest is autograd's own (the Function's graph and ``backward()``)."""
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    attn, causal, cot = run["attn"], run["causal"], run["cot"]
    q, k, v = (x.detach() for x in run["inputs"])
    kw = dict(scale=q.shape[-1]**-0.5, causal=causal, block=attn.sparsity_config.block)
    o, lse = sa.sparse_fwd(q, k, v, *lists[:2], order=orders[0], **kw)

    def forward():
        with torch.no_grad():
            attn(q, k, v)

    host = {"iteration": _host_ms(step), "module_forward_no_grad": _host_ms(forward),
            "backward_wrapper": _host_ms(lambda: sa.sparse_bwd(
                q, k, v, o, lse, cot, *lists, q_order=orders[0], k_order=orders[1], **kw))}
    host["autograd_rest"] = host["iteration"] - host["module_forward_no_grad"] - host["backward_wrapper"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in device_events(prof)) / 1e3 / iters
    result = {"device_busy_ms_per_iteration": busy,
              "device_idle_share": 1.0 - busy / run["ms"], "host_ms_per_call": host}
    log(f"sparse {name} profile: device busy {busy:.4f} ms per iteration of {run['ms']:.4f}, idle "
        f"share {result['device_idle_share']:.3f}; host ms per call (unprofiled): iteration "
        f"{host['iteration']:.4f} = module forward without a graph "
        f"{host['module_forward_no_grad']:.4f} + K6 backward wrapper {host['backward_wrapper']:.4f} "
        f"+ autograd's rest {host['autograd_rest']:.4f}  [{card}]")
    return result


def sparse_phase(seed: int, card: str, warmup: int = 2, iters: int = 10):
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches
    from deepspeed_tpu_torch.ops.sparse_attention import (DenseSparsityConfig, SparseSelfAttention,
                                                          sparse_attention)
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import index_lists_on

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    runs = {}
    for name, (cfg, shape, causal) in sparse_configs(seed).items():
        attn = SparseSelfAttention(cfg)
        attn.get_index_lists(shape[1], "cuda")  # layout, index lists and launch orders: set-up, once
        attn.get_launch_orders(shape[1], "cuda")
        runs[name] = dict(attn=attn, shape=shape, causal=causal,
                          inputs=_leaves(*(randn(*shape) for _ in range(3))), cot=randn(*shape))
    torch.cuda.synchronize()

    def iteration(run):
        q, k, v = run["inputs"]
        for x in (q, k, v):
            x.grad = None
        o = run["attn"](q, k, v)
        o.backward(run["cot"])
        return o

    # ---- the main path: counts zeroed just before, read just after ----
    reset_launches()
    for run in runs.values():
        before = launches()
        for _ in range(warmup):
            iteration(run)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run["o"] = iteration(run)
        torch.cuda.synchronize()
        run["ms"] = (time.perf_counter() - t0) * 1e3 / iters
        run["launches"] = {k: c - before[k] for k, c in launches().items()}
    counts = launches()
    # ---- end of the main path ----

    out = {}
    for name, run in runs.items():
        want = {k: (warmup + iters if k in SPARSE_KERNELS else 0) for k in counts}
        if run["launches"] != want:
            raise AssertionError(f"sparse {name}: expected K6 forward and backward once per iteration "
                                 f"and no other kernel, got {run['launches']}")
        b, l, h, d = run["shape"]
        attn, causal, cot = run["attn"], run["causal"], run["cot"]
        q, k, v = run["inputs"]
        block = attn.sparsity_config.block
        lists = attn.get_index_lists(l, "cuda")
        got = (run["o"], q.grad, k.grad, v.grad)
        err_bf16 = _compare_path(f"sparse path {name} bf16 (card vs plain)", got,
                                 _plain_path(lists, block, q, k, v, cot, causal), torch.bfloat16)
        qf, kf, vf = _leaves(q.float(), k.float(), v.float())
        of = attn(qf, kf, vf)
        of.backward(cot.float())
        err_fp32 = _compare_path(f"sparse path {name} fp32 (card vs plain)", (of, qf.grad, kf.grad, vf.grad),
                                 _plain_path(lists, block, qf, kf, vf, cot.float(), causal), torch.float32)
        del of, qf, kf, vf

        # NaN probe: NaN K/V rows in a key block the layout leaves dead
        dead = 5 if name == "fixed" else l // block // 2 + 1
        layout = attn.get_layout(l).copy()
        layout[:, :, dead] = 0
        rows = slice(dead * block, (dead + 1) * block)
        qn, kn, vn = (x.detach().clone() for x in (q, k, v))
        kn[:, rows] = float("nan")
        vn[:, rows] = float("nan")
        qn, kn, vn = _leaves(qn, kn, vn)
        on = sparse_attention(qn, kn, vn, layout, block, causal=causal)
        on.backward(cot)
        _compare_path(f"sparse NaN probe {name} bf16 (key block {dead} dead)",
                      (on, qn.grad, kn.grad, vn.grad),
                      _plain_path(index_lists_on(layout, "cuda"), block, qn, kn, vn, cot, causal),
                      torch.bfloat16)
        if (kn.grad[:, rows] != 0).any() or (vn.grad[:, rows] != 0).any():
            raise AssertionError(f"sparse NaN probe {name}: dk or dv not zero in the dead block")
        RESULTS["checks"].append({"name": f"sparse NaN probe {name}: finite, dk = dv = 0 in the dead block",
                                  "ok": True})
        del on, qn, kn, vn
        torch.cuda.empty_cache()
        out[name] = dict(shape=list(run["shape"]), causal=causal, launches=run["launches"],
                         ms_per_iteration=run["ms"], max_abs_err_bf16=err_bf16, max_abs_err_fp32=err_fp32)
        log(f"sparse {name} [{b},{l},{h},{d}] bf16 block {block}{' causal' if causal else ''}: "
            f"SparseSelfAttention forward + backward {run['ms']:.3f} ms per iteration over {iters} "
            f"(after {warmup}); launches {run['launches']['sparse_fwd']} forward, "
            f"{run['launches']['sparse_bwd']} backward  [{card}]")
        out[name]["profile"] = _profile_sparse(run, lambda: iteration(run), name, lists,
                                               attn.get_launch_orders(l, "cuda"), card)
    del runs

    # a dense layout against K1 and K4 on the same inputs, and K1 + K4 at shape (a)
    b, l, h, d = sparse_configs(seed)["fixed"][1]
    dense = SparseSelfAttention(DenseSparsityConfig(num_heads=h, block=64))
    q, k, v, cot = (randn(b, l, h, d) for _ in range(4))
    for causal in (True, False):
        qs, ks, vs = _leaves(q, k, v)
        o = dense(qs, ks, vs, causal=causal)
        o.backward(cot)
        qf, kf, vf = _leaves(q, k, v)
        of = fa.flash_attention(qf, kf, vf, causal=causal)
        of.backward(cot)
        _compare_path(f"dense layout [{b},{l},{h},{d}] bf16 causal={causal} (K6 vs K1/K4)",
                      (o, qs.grad, ks.grad, vs.grad), (of, qf.grad, kf.grad, vf.grad), torch.bfloat16)
    del o, of, qs, ks, vs, qf, kf, vf
    kw = dict(scale=d**-0.5, causal=True)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    k1_ms = time_ms(lambda: fa.flash_fwd(q, k, v, **kw), iters=10)
    k4_ms = time_ms(lambda: fa.flash_bwd(q, k, v, o, lse, cot, **kw), iters=10)
    k6 = RESULTS["timings"]["sparse_attention"]["fixed"]
    k6_ms = k6["sparse_fwd"]["ms"] + k6["sparse_bwd"]["ms"]
    out["dense_causal_k1_k4"] = dict(k1_ms=k1_ms, k4_ms=k4_ms, fixed_k6_ms=k6_ms)
    log(f"sparse (a) against dense causal at [{b},{l},{h},{d}] bf16: K1 {k1_ms:.4f} + K4 {k4_ms:.4f} = "
        f"{k1_ms + k4_ms:.4f} ms, K6 fixed forward + backward {k6_ms:.4f} ms "
        f"({(k1_ms + k4_ms) / k6_ms:.2f}x)  [{card}]")
    return out, counts


# ---------------------------------------------------------------------------
# phase 10: the engine's own API and its checkpoints
# ---------------------------------------------------------------------------
#: phase 10's model
API_MODEL = dict(name="350m", vocab_size=50304, n_positions=1024, fused_head_loss_chunk=1024)
API_GAS = 2


def api_config() -> dict:
    """Phase 10's engine config: the training phase's at ``train_batch_size``
    16 over two micro-batches of 8, every loaded leaf re-hashed."""
    return dict(train_config(8, 1.0, True), train_batch_size=16, gradient_accumulation_steps=API_GAS,
                resilience={"verify_checkpoint": "full", "fallback_on_corruption": True})


def _api_engine(seed: int, **model_kw):
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, initialize
    kw = dict(API_MODEL, remat=True, dtype=torch.bfloat16)
    kw.update(model_kw)
    cfg = get_gpt2_config(kw.pop("name"), **kw)
    model = GPT2LMHeadModel(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    return initialize(model=model, config=api_config(), device="cuda")[0]


def _params(engine) -> list:
    return [p.detach().clone() for p in engine.module.parameters()]


def _same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


#: where a checkpoint save and load spend their time: (label, file suffix,
#: function name) of the calls whose cumulative time ``cProfile`` reads;
#: the rest is mostly ``torch.save`` / ``torch.load`` (which ``cProfile``
#: does not list under their own names)
SAVE_PARTS = (("device-to-host copies", "torch_engine.py", "_host_copy"),
              ("leaf digests", "manifest.py", "state_leaf_entries"),
              ("file digests", "manifest.py", "file_inventory"),
              ("fsync", "manifest.py", "fsync_tree"))
LOAD_PARTS = (("file digests", "manifest.py", "verify_checkpoint_dir"),
              ("leaf digests", "manifest.py", "verify_state_leaves"),
              ("copies into the live tensors", "~", "<method 'copy_' of 'torch._C.TensorBase' objects>"))
INTERLEAVED_PAIRS = 6


def _profiled(fn, parts) -> dict:
    """``fn()`` under ``cProfile``: its seconds, and the cumulative seconds
    of each of ``parts``."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    split = {label: sum(v[3] for (f, _, name), v in stats.items() if f.endswith(suffix) and name == func)
             for label, suffix, func in parts}
    split["rest (torch.save or torch.load)"] = total - sum(split.values())
    return {"s": total, "by_part_s": split}


def _run_train_batch(engine, batches, first: int = 0, saves=None):
    """``train_batch`` over ``batches``; ``saves``: ``{step: (dir, tag)}``
    saved after that step (counted from 1), timed and split by part.
    Returns the losses, the ms of each step and the saves' seconds and
    GB."""
    losses, step_ms, saved = [], [], {}
    for i, b in enumerate(batches, start=first + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(engine.train_batch(b))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if saves and i in saves:
            where, tag = saves[i]
            saved[tag] = _profiled(lambda: engine.save_checkpoint(where, tag=tag), SAVE_PARTS)
            saved[tag]["gb"] = _dir_bytes(os.path.join(where, tag)) / 1e9
    return losses, step_ms, saved


def _run_shims(engine, batches):
    """The same steps through forward/backward/step: each batch's two
    micro-batches, ``step()`` after each backward (a no-op after the
    first). Returns the mean micro-batch losses and the ms of each step."""
    losses, step_ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        micro = []
        n = b.shape[0] // API_GAS
        for j in range(API_GAS):
            loss = engine.forward({"input_ids": b[j * n:(j + 1) * n]})
            engine.backward(loss)
            micro.append(loss.detach().float())
            steps = engine.global_steps
            engine.step()
            if j < API_GAS - 1 and engine.global_steps != steps:
                raise AssertionError("engine api: step() between boundaries moved global_steps")
        losses.append(torch.stack(micro).mean())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def _ms_summary(ms: list) -> dict:
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3), "min": min(ms), "max": max(ms),
            "n": len(ms)}


def _check_api_pair(what: str, seed: int, batches, counts: dict, saves=None, **model_kw):
    """(a) for one model: ``train_batch`` twice from one init (the card's
    own bit-determinism; the first run makes ``saves``) and
    forward/backward/step once; losses and final parameters bit-equal.
    Launch counts of each side zeroed just before it and read just after,
    summed into ``counts``. Returns the results and the first run's final
    parameters."""
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches
    sides = {}
    for side in ("train_batch", "train_batch again", "forward/backward/step"):
        engine = _api_engine(seed, **model_kw)
        reset_launches()
        if side == "train_batch":
            losses, step_ms, saved = _run_train_batch(engine, batches, saves=saves)
        elif side == "train_batch again":
            losses, step_ms, _ = _run_train_batch(engine, batches)
        else:
            losses, step_ms = _run_shims(engine, batches)
        side_counts = launches()
        for k, c in side_counts.items():
            counts[k] = counts.get(k, 0) + c
        sides[side] = dict(losses=[float(x) for x in losses], loss_bits=losses, params=_params(engine),
                           step_ms=step_ms, launches=side_counts, steps=engine.global_steps)
        if side == "forward/backward/step":
            # the step's ms by API on this warm engine, in turns, each pair
            # in the other order than the one before
            runs = (("train_batch", _run_train_batch), ("forward/backward/step", _run_shims))
            interleaved = {name: [] for name, _ in runs}
            for i in range(INTERLEAVED_PAIRS):
                for name, run in (runs if i % 2 == 0 else runs[::-1]):
                    interleaved[name] += run(engine, [batches[i % len(batches)]])[1]
        del engine
    ref, again, shims = (sides[k] for k in ("train_batch", "train_batch again", "forward/backward/step"))
    deterministic = (all(torch.equal(x, y) for x, y in zip(ref["loss_bits"], again["loss_bits"]))
                     and _same_bits(ref["params"], again["params"]))
    if not deterministic:
        raise AssertionError(f"engine api {what}: two train_batch runs from one init differ on the card "
                             f"(losses {ref['losses']} vs {again['losses']})")
    if not (all(torch.equal(x, y) for x, y in zip(ref["loss_bits"], shims["loss_bits"]))
            and _same_bits(ref["params"], shims["params"])):
        raise AssertionError(f"engine api {what}: forward/backward/step differs from train_batch "
                             f"(losses {shims['losses']} vs {ref['losses']})")
    if not ref["steps"] == shims["steps"] == len(batches):
        raise AssertionError(f"engine api {what}: global_steps {ref['steps']} / {shims['steps']}")
    timed = {k: _ms_summary(v["step_ms"][1:]) for k, v in sides.items()}
    RESULTS["checks"].append({"name": f"engine api {what}: train_batch == forward/backward/step, bit for bit",
                              "ok": True})
    return {"losses": ref["losses"], "step_ms": timed, "saved": saved,
            "interleaved_step_ms": {k: _ms_summary(v) for k, v in interleaved.items()},
            "launches": {k: v["launches"] for k, v in sides.items()}}, ref["params"]


def _linked_copy(src: str, dst: str) -> None:
    """A copy of a checkpoint dir whose files are hard links (no bytes
    copied); :func:`_own_file` gives a file its own bytes before it is
    damaged."""
    shutil.copytree(src, dst, copy_function=os.link)


def _own_file(path: str) -> None:
    shutil.copyfile(path, path + ".copy")
    os.replace(path + ".copy", path)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.ERROR)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _corruption_probes(engine, base: str, work: str, batches, want_losses) -> dict:
    """(c) on copies of the dense tags ``step2`` and ``step4``: a flipped
    byte in the newest tag's module file and a truncated optimizer file must
    each fall back to ``step2``, with the error logged (the flipped-byte
    fallback then trains steps 3-4 to the uninterrupted losses); an explicit
    ``tag=`` of a corrupt tag with no older tag must raise."""
    from deepspeed_tpu_torch.runtime.resilience.manifest import CheckpointCorruptError
    records = _Records()
    logging.getLogger("deepspeed_tpu_torch").addHandler(records)
    out = {}
    try:
        for probe in ("flipped byte", "truncated file"):
            copy = os.path.join(work, probe.replace(" ", "_"))
            _linked_copy(base, copy)
            target = os.path.join(copy, "step4", "state",
                                  "module.pt" if probe == "flipped byte" else "optimizer.pt")
            _own_file(target)
            size = os.path.getsize(target)
            if probe == "flipped byte":
                with open(target, "r+b") as f:
                    f.seek(size // 2)
                    byte = f.read(1)
                    f.seek(size // 2)
                    f.write(bytes([byte[0] ^ 0x10]))
            else:
                os.truncate(target, size // 2)
            records.messages.clear()
            t0 = time.perf_counter()
            engine.load_checkpoint(copy)
            load_s = time.perf_counter() - t0
            logged = [m for m in records.messages if "step4" in m and "corrupt" in m]
            if engine.loaded_checkpoint_tag != "step2" or engine.global_steps != 2 or not logged:
                raise AssertionError(f"corruption probe {probe}: loaded {engine.loaded_checkpoint_tag} "
                                     f"at step {engine.global_steps}, logged {records.messages}")
            out[probe] = {"fell_back_to": "step2", "load_s": load_s, "logged": logged[0][:300]}
            if probe == "flipped byte":
                losses = [float(x) for x in _run_train_batch(engine, batches[2:], first=2)[0]]
                if losses != want_losses[2:]:
                    raise AssertionError(f"corruption probe: steps 3-4 after the fallback {losses} vs "
                                         f"{want_losses[2:]}")
            shutil.rmtree(copy)
        alone = os.path.join(work, "explicit")
        os.makedirs(alone)
        _linked_copy(os.path.join(base, "step2"), os.path.join(alone, "step2"))
        target = os.path.join(alone, "step2", "state", "rng.pt")
        _own_file(target)
        with open(target, "r+b") as f:
            byte = f.read(1)
            f.seek(0)
            f.write(bytes([byte[0] ^ 0x01]))
        try:
            engine.load_checkpoint(alone, tag="step2")
        except CheckpointCorruptError as e:
            out["explicit corrupt tag, nothing older"] = {"raised": str(e)[:300]}
        else:
            raise AssertionError("corruption probe: an explicit corrupt tag with nothing older loaded")
        shutil.rmtree(alone)
    finally:
        logging.getLogger("deepspeed_tpu_torch").removeHandler(records)
    RESULTS["checks"].append({"name": "engine api corruption probes (fallback to the older tag, or raise)",
                              "ok": True})
    return out


def _check_16bit(engine, where: str) -> dict:
    """(d) ``save_16bit_model``: 2 bytes a parameter, and its bits read
    back equal to the parameters rounded to bf16, under the JAX paths."""
    from deepspeed_tpu_torch.checkpoint.from_jax import params_to_jax
    t0 = time.perf_counter()
    path = engine.save_16bit_model(where)
    save_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in engine.module.parameters())
    want = params_to_jax({k: p.detach().to(torch.bfloat16) for k, p in engine.module.named_parameters()})
    with np.load(path) as z:
        dtypes = json.loads(bytes(z["__dtypes__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__dtypes__"}
    if set(arrays) != set(want) or set(dtypes.values()) != {"bfloat16"}:
        raise AssertionError(f"16-bit model: keys or dtypes differ ({sorted(set(arrays) ^ set(want))[:4]})")
    if sum(a.nbytes for a in arrays.values()) != 2 * n_params:
        raise AssertionError("16-bit model: not 2 bytes a parameter")
    bad = [k for k, a in arrays.items() if not np.array_equal(a, want[k])]
    if bad:
        raise AssertionError(f"16-bit model: bits differ from the parameters rounded to bf16: {bad[:4]}")
    size = os.path.getsize(path)
    RESULTS["checks"].append({"name": "engine api 16-bit model: bf16 bits, 2 bytes a parameter", "ok": True})
    return {"path": os.path.basename(path), "bytes": size, "n_params": n_params,
            "bytes_per_param": size / n_params, "save_s": save_s}


def _check_resume(what: str, seed: int, batches, ref_losses, ref_params, where: str, **model_kw):
    """(b) a fresh engine loads ``step2`` and trains steps 3-4: the losses
    and the parameters bit-equal to the uninterrupted run's. Returns the
    engine and the load's seconds by part."""
    engine = _api_engine(seed + 100, **model_kw)  # other weights, so the load must take
    loaded = _profiled(lambda: engine.load_checkpoint(where, tag="step2"), LOAD_PARTS)
    losses = [float(x) for x in _run_train_batch(engine, batches[2:], first=2)[0]]
    if losses != ref_losses[2:] or not _same_bits(_params(engine), ref_params):
        raise AssertionError(f"engine api {what}: the resumed run differs from the uninterrupted one "
                             f"(losses {losses} vs {ref_losses[2:]})")
    RESULTS["checks"].append({"name": f"engine api {what}: load step2 + 2 steps == uninterrupted, bit for bit",
                              "ok": True})
    return engine, {"load": loaded, "losses_3_4": losses}


def _snapshot(engine):
    return ({k: v.detach().clone() for k, v in engine.checkpoint_state().items()},
            (engine.global_steps, engine.global_samples, engine.micro_steps, engine.skipped_steps))


def _restore(engine, snap) -> None:
    from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_engine import OPTIMIZER_GROUP
    from deepspeed_tpu_torch.runtime.engine import RNG_KEY
    state, counters = snap
    live = engine.checkpoint_state()
    with torch.no_grad():
        for k, v in state.items():
            live[k].copy_(v)
    engine.optimizer.count = int(state[f"{OPTIMIZER_GROUP}/count"])
    engine.generator.set_state(state[RNG_KEY])
    engine.global_steps, engine.global_samples, engine.micro_steps, engine.skipped_steps = counters


def _check_gate_stats(engine, batch, card: str) -> dict:
    """(e) ``moe_gate_stats`` on phase 7's engine leaves its next step as it
    was: from one snapshot, the next loss and gradient norm with and
    without a stats call before them agree in every bit, and the call
    leaves the engine's generator as it was."""
    snap = _snapshot(engine)
    want = engine.train_batch(batch)
    want_norm = engine.get_global_grad_norm()
    _restore(engine, snap)
    del snap
    gen = engine.generator.get_state()
    t0 = time.perf_counter()
    stats = engine.moe_gate_stats(batch)
    torch.cuda.synchronize()
    stats_s = time.perf_counter() - t0
    if not torch.equal(engine.generator.get_state(), gen):
        raise AssertionError("moe_gate_stats drew from the training generator")
    got = engine.train_batch(batch)
    if not torch.equal(got, want) or engine.get_global_grad_norm() != want_norm:
        raise AssertionError(f"moe_gate_stats changed the next step: loss {float(got)} vs {float(want)}")
    layers = {k: {"kept": int(v["kept_counts"].sum()), "routed": int(v["exp_counts"].sum()),
                  "capacity_slots": v["capacity_slots"], "max_expert": int(v["exp_counts"].max())}
              for k, v in stats.items()}
    log(f"engine api moe_gate_stats: {len(stats)} MoE layers, {stats_s:.3f} s; next loss "
        f"{float(got):.6f} bit-equal with and without the call; {layers}  [{card}]")
    RESULTS["checks"].append({"name": "engine api moe_gate_stats leaves the next step unchanged", "ok": True})
    return {"layers": layers, "stats_s": stats_s, "next_loss": float(got)}


def engine_api_phase(seed: int, card: str):
    """Phase 10 (module docstring) but for (e)'s ``moe_gate_stats`` check,
    which runs on phase 7's engine (:func:`_check_gate_stats`). Returns its
    results and the launch counts of its main path: every run of (a) and
    (e), each zeroed just before and read just after."""
    counts = {}
    out = {}
    rng = np.random.default_rng(seed + 10)
    vocab = API_MODEL["vocab_size"]
    batches = [rng.integers(0, vocab, (16, API_MODEL["n_positions"])).astype(np.int32) for _ in range(4)]
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        out["free_gb_at_start"] = shutil.disk_usage(work).free / 1e9
        # (a) flash, dropout 0: K1 and K4 on both APIs
        flash = out["a_flash"] = _check_api_pair("flash", seed + 10, batches, counts,
                                                 attention_backend="flash")[0]
        missing = [k for k in TRAINING_KERNELS if any(v[k] <= 0 for v in flash["launches"].values())]
        if missing:
            raise AssertionError(f"engine api: {missing} never launched on one side: {flash['launches']}")
        # (a) dropout 0.1: the "xla" backend (the flash kernels take no
        # dropout); its first run saves step2 and step4
        drop = dict(attention_backend="xla", dropout=0.1)
        dense = os.path.join(work, "dense")
        out["a_dropout"], ref_params = _check_api_pair(
            "dropout 0.1", seed + 10, batches, counts,
            saves={2: (dense, "step2"), 4: (dense, "step4")}, **drop)
        # (b) resume from step2 with verify "full"
        engine, out["b_resume"] = _check_resume("dropout 0.1 resume", seed + 10, batches,
                                                out["a_dropout"]["losses"], ref_params, dense, **drop)
        # (c) corruption probes, (d) the 16-bit model
        out["c_corruption"] = _corruption_probes(engine, dense, work, batches,
                                                 out["a_dropout"]["losses"])
        out["d_16bit"] = _check_16bit(engine, os.path.join(work, "bf16"))
        del engine, ref_params
        shutil.rmtree(dense)
        # (e) MoE at 2 layers: both APIs, then save, load, resume bit-exact
        # (the RTS draws cross with the generator's state)
        moe = dict(n_layer=2, attention_backend="flash", moe_num_experts=8, moe_layer_freq=2, moe_k=1,
                   moe_use_rts=True)
        moe_dir = os.path.join(work, "moe")
        before = dict(counts)
        out["e_moe"], moe_params = _check_api_pair("MoE RTS", seed + 11, batches, counts,
                                                   saves={2: (moe_dir, "step2")}, **moe)
        missing = [k for k in MOE_TRAINING_KERNELS if counts[k] - before.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"engine api MoE: {missing} never launched: {out['e_moe']['launches']}")
        engine, out["e_moe"]["resume"] = _check_resume("MoE RTS resume", seed + 11, batches,
                                                       out["e_moe"]["losses"], moe_params, moe_dir, **moe)
        del engine, moe_params
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sv, ld = out["a_dropout"]["saved"]["step2"], out["b_resume"]["load"]

    def ms(d):
        return ", ".join(f"{k} {v['median']:.2f} [{v['q1']:.2f}, {v['q3']:.2f}] (n {v['n']})"
                         for k, v in d.items())

    def parts(d):
        return ", ".join(f"{k} {v:.2f}" for k, v in d["by_part_s"].items())

    log(f"engine api (a): flash, dropout 0: train_batch == forward/backward/step bit for bit over 4 "
        f"steps, losses {flash['losses']}; step ms median [q1, q3], steps 2-4 of each run: "
        f"{ms(flash['step_ms'])}; in turns on one warm engine: {ms(flash['interleaved_step_ms'])}; "
        f"launches per side {flash['launches']['forward/backward/step']}  [{card}]")
    log(f"engine api (a): xla, dropout 0.1: bit for bit, losses {out['a_dropout']['losses']}; step "
        f"ms in turns: {ms(out['a_dropout']['interleaved_step_ms'])}  [{card}]")
    log(f"engine api (b): save step2 {sv['s']:.2f} s ({parts(sv)}), {sv['gb']:.3f} GB; load (verify "
        f"full) {ld['s']:.2f} s ({parts(ld)}); steps 3-4 bit-equal to the uninterrupted run  [{card}]")
    log(f"engine api (c): {out['c_corruption']}  [{card}]")
    log(f"engine api (d): 16-bit model {out['d_16bit']}  [{card}]")
    log(f"engine api (e): MoE 2 layers, RTS: train_batch == forward/backward/step bit for bit; load "
        f"step2 {out['e_moe']['resume']['load']['s']:.2f} s, steps 3-4 bit-equal; launches on the "
        f"path {counts}  [{card}]")
    return out, counts


# ---------------------------------------------------------------------------
# phase 3 at head dim 128: K1, K4 and K3 at the LLaMA family's width
# ---------------------------------------------------------------------------
#: the LLaMA shapes of K1, K4 and K3: LLaMA-1b training (micro-batch 4, seq
#: 2048, 16 heads), LLaMA-7b serving (4 rows, 2048 positions, 32 heads)
LLAMA_TRAIN_SHAPE = (4, 2048, 16, 128)
LLAMA_SERVE_SHAPE = (4, 2048, 32, 128)
#: K3's LLaMA-7b calls: the token loop's mid-generate lengths (512 prompt +
#: 32 generated) at Lq 1, and the last 16-token prefill chunk at Lq 16
LLAMA_K3_CALLS = ((1, [544] * 4), (16, [512] * 4))


def _d128_stats() -> dict:
    """Registers and local-memory bytes of every head-dim-128 instance of
    K1, K4 and K3 (``cuobjdump -res-usage``), by library and kernel."""
    out = {}
    for lib_name in ("flash_fwd", "flash_bwd", "flash_decode"):
        stats = sass_stats(lib_name)
        RESULTS.setdefault("sass", {})[lib_name] = stats
        out[lib_name] = {fn: {"registers": st.get("registers"), "local_bytes": st.get("local_bytes"),
                              "hmma": st["hmma"]}
                         for fn, st in stats.items() if "128" in fn}
        log(f"{lib_name} head dim 128 registers / local bytes / HMMA by kernel: " + "; ".join(
            f"{fn} {st['registers']} / {st['local_bytes']} / {st['hmma']}"
            for fn, st in sorted(out[lib_name].items())))
        mma = {fn: st for fn, st in out[lib_name].items() if "mma" in fn or "tile" in fn}
        if not mma or not all(st["hmma"] > 0 for st in mma.values()):
            raise AssertionError(f"{lib_name}: a head-dim-128 bf16 kernel without HMMA instructions: "
                                 f"{out[lib_name]}")
    return out


def kernel_phase_d128(gen: torch.Generator, seed: int) -> dict:
    """K1, K4 and K3 at head dim 128: against their plain versions (causal,
    kv_lengths, window, fp32 and bf16, K3's row and tile bodies in both
    operand forms) and their exact probes, then timed at the LLaMA shapes
    beside their plain versions, SDPA (device-side) and the bound, with
    each instance's registers and spills. Returns the kernels line's
    ``at_head_dim_128`` entries."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda")
    d = 128
    scale = d**-0.5

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def k1k4(name, b, h, lq, lk, dtype, causal=True, kv_lengths=None, window=None):
        q, k, v = randn(b, lq, h, d, dtype=dtype), randn(b, lk, h, d, dtype=dtype), randn(b, lk, h, d, dtype=dtype)
        do = randn(b, lq, h, d, dtype=dtype)
        lens = None if kv_lengths is None else torch.tensor(kv_lengths, dtype=torch.int32, device=dev)
        kw = dict(scale=scale, causal=causal, kv_lengths=lens, window=window)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        ro, rlse = fa.flash_fwd_plain(q, k, v, **kw)
        err_f = compare(f"flash_fwd {name}", o, ro, dtype)
        live = rlse > -1e30
        if not torch.equal(live, lse > -1e30):
            raise AssertionError(f"flash_fwd {name}: rows with no live key differ")
        compare(f"flash_fwd {name} lse", lse[live], rlse[live], torch.float32 if dtype == torch.float32 else dtype)
        del ro, rlse
        got = fa.flash_bwd(q, k, v, o, lse, do, **kw)
        ref = fa.flash_bwd_plain(q, k, v, o, lse, do, **kw)
        err_b = max(compare(f"flash_bwd {name} d{x}", g, r, dtype) for x, g, r in zip("qkv", got, ref))
        return (q, k, v, o, lse, do), err_f, err_b

    k1k4("[2,4,256,128] fp32 causal", 2, 4, 256, 256, torch.float32)
    k1k4("[2,4,200,128] fp32 causal kv_lengths 0,70", 2, 4, 200, 200, torch.float32, kv_lengths=[0, 70])
    k1k4("[3,4,200,128] bf16 kv_lengths 200,77,0", 3, 4, 200, 200, torch.bfloat16, causal=False,
         kv_lengths=[200, 77, 0])
    k1k4("[2,4,130,128] bf16 causal kv_lengths 130,50", 2, 4, 130, 130, torch.bfloat16, kv_lengths=[130, 50])
    k1k4("[2,4,300,128] bf16 causal window=100", 2, 4, 300, 300, torch.bfloat16, window=100)
    k1k4("[1,8,1024,128] bf16 causal window=256 (phase 12's Mistral width)", 1, 8, 1024, 1024,
         torch.bfloat16, window=256)
    k1k4("[2,4,16,300,128] bf16 causal lq<lk", 2, 4, 16, 300, torch.bfloat16)

    k1k4_probe_err = exact_probes(seed, head_dim=d)
    k3_probe_err = decode_exact_probes(seed, head_dim=d)

    # K3 against its plain version: both bodies, both forms, fp32 and bf16
    def k3(name, lq, lengths, dtype, h, p_len):
        q = randn(len(lengths), lq, h, d, dtype=dtype)
        codes = torch.randint(-127, 128, (2, len(lengths), p_len, h, d), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.int8)
        scales = (torch.rand(2, len(lengths), p_len, h, 1, generator=gen, device=dev) * 0.05 + 1e-3).to(dtype)
        k, v = fa.dequantize_kv(codes[0], scales[0], dtype), fa.dequantize_kv(codes[1], scales[1], dtype)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        o = fa.flash_decode(q, k, v, lens)
        err = compare(f"flash_decode {name} values", o, fa.flash_decode_plain(q, k, v, lens, scale=scale), dtype)
        o8 = fa.flash_decode(q, codes[0], codes[1], lens, k_scale=scales[0], v_scale=scales[1])
        compare_exact(f"flash_decode {name}: int8 form = value form on the dequantised pool", o8, o)
        return q, k, v, lens, err

    k3("S=8 Lq=16 P=1024 h=4 bf16 lengths 0,1,P,P+Lq", 16, [0, 1, 15, 16, 300, 1000, 1024, 1040],
       torch.bfloat16, 4, 1024)
    k3("S=8 Lq=1 P=1024 h=4 bf16 lengths 0,1,P,P+Lq", 1, [0, 1, 2, 64, 65, 1000, 1024, 1025],
       torch.bfloat16, 4, 1024)
    k3("S=4 Lq=16 P=1024 h=4 fp32", 16, [5, 16, 700, 1040], torch.float32, 4, 1024)
    k3("S=4 Lq=1 P=1024 h=4 fp32", 1, [5, 16, 700, 1025], torch.float32, 4, 1024)
    k3_ops = {}
    for lq, lengths in LLAMA_K3_CALLS:
        k3_ops[lq] = k3(f"[4,{lq},32,128] P=2048 bf16 lengths {lengths} (LLaMA-7b generate)", lq, lengths,
                        torch.bfloat16, 32, 2048)

    # timings at the LLaMA shapes
    lines = {}
    fwd_times = {}
    for shape, what in ((LLAMA_TRAIN_SHAPE, "LLaMA-1b training"), (LLAMA_SERVE_SHAPE, "LLaMA-7b serving forward")):
        b, l, h, _ = shape
        (q, k, v, o, lse, do), err_f, err_b = k1k4(f"[{b},{l},{h},128] bf16 causal ({what})", b, h, l, l,
                                                   torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        fwd = lambda: fa.flash_fwd(q, k, v, scale=scale, causal=True)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
        pairs = b * h * l * (l + 1) / 2
        bnd, by = bound_ms(4 * b * h * l * d * 2 + b * h * l * 4, 4 * d * pairs)
        fwd_times[what] = dict(
            name="flash_fwd", route="cuda", source="deepspeed_tpu_torch/csrc/flash_fwd.cu",
            replaces="deepspeed_tpu/ops/pallas/flash_attention.py:117",
            shape=f"q,k,v [{b},{l},{h},128] bf16 causal ({what})", max_abs_err=err_f,
            ms=time_ms(fwd, iters=10), device_ms=device_ms(fwd),
            plain_ms=time_ms(lambda: fa.flash_fwd_plain(q, k, v, scale=scale, causal=True), iters=2, warmup=1),
            bound_ms=bnd, bound_by=by, library_ms=device_ms(sdpa), library_event_ms=time_ms(sdpa, iters=10))
        log_time(fwd_times[what])
        if what != "LLaMA-1b training":
            del q, k, v, o, lse, do, qt, kt, vt
            continue
        kw = dict(scale=scale, causal=True)
        bwd = lambda: fa.flash_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
        split = {short_name(name): t for name, t in device_times(bwd).items()}
        log("K4 head dim 128 device ms by kernel: " + ", ".join(f"{n} {t:.4f}" for n, t in split.items()))
        qg, kg, vg = (x.requires_grad_() for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        sdpa_bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True)  # noqa: E731
        lib_split = {name[:60]: t for name, t in device_times(sdpa_bwd).items()}
        log("SDPA backward head dim 128 device ms by kernel: "
            + ", ".join(f"{n} {t:.4f}" for n, t in lib_split.items()))
        bnd, by = bound_ms(8 * b * h * l * d * 2 + b * h * l * 4, 10 * d * pairs)
        lines["flash_bwd"] = dict(
            name="flash_bwd", route="cuda", source="deepspeed_tpu_torch/csrc/flash_bwd.cu",
            replaces="deepspeed_tpu/ops/pallas/flash_attention.py:403",
            shape=f"q,k,v,o,dO [{b},{l},{h},128] bf16 causal (LLaMA-1b training)", max_abs_err=err_b,
            ms=time_ms(bwd, iters=10), device_ms=sum(split.values()),
            plain_ms=time_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, **kw), iters=2, warmup=1),
            bound_ms=bnd, bound_by=by, library_ms=sum(lib_split.values()),
            library_event_ms=time_ms(sdpa_bwd, iters=10), device_ms_by_kernel=split,
            library_device_ms_by_kernel=lib_split, exact_probe_max_abs_err=k1k4_probe_err)
        log_time(lines["flash_bwd"])
        del q, k, v, o, lse, do, qt, kt, vt, qg, kg, vg, out, dot, sdpa_bwd
    lines["flash_fwd"] = dict(fwd_times["LLaMA-1b training"], exact_probe_max_abs_err=k1k4_probe_err,
                              serving_forward=fwd_times["LLaMA-7b serving forward"])

    dec = {}
    kpos = torch.arange(2048, device=dev)
    for lq, lengths in LLAMA_K3_CALLS:
        q, k, v, lens, err = k3_ops[lq]
        qpos = lens.long()[:, None] - lq + torch.arange(lq, device=dev)[None, :]
        mask = ((kpos[None, None, :] <= qpos[:, :, None])
                & (kpos[None, None, :] < lens.long().clamp(0, 2048)[:, None, None]))[:, None]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kernel = lambda: fa.flash_decode(q, k, v, lens)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
        live = sum(min(x, 2048) for x in lengths)
        nbytes = live * 32 * d * 2 * 2 + 2 * q.numel() * 2 + lens.numel() * 4
        s, _, h, _ = q.shape
        pairs = sum(max(0, min(x, x - lq + r + 1)) for x in lengths for r in range(lq))
        bnd, by = bound_ms(nbytes, 4 * d * h * pairs)
        body = "tile" if lq > 1 else "row"
        dec[lq] = dict(name="flash_decode", route="cuda", source="deepspeed_tpu_torch/csrc/flash_decode.cu",
                       replaces="deepspeed_tpu/ops/pallas/flash_attention.py:555",
                       shape=f"q [4,{lq},32,128], k/v [4,2048,32,128] bf16, lengths {lengths} ({body} body)",
                       max_abs_err=err, ms=time_ms(kernel, iters=50), device_ms=device_ms(kernel),
                       plain_ms=time_ms(lambda: fa.flash_decode_plain(q, k, v, lens, scale=scale), iters=5,
                                        warmup=1),
                       bound_ms=bnd, bound_by=by, library_ms=device_ms(sdpa), library_event_ms=time_ms(sdpa, iters=50))
        log_time(dec[lq])
    lines["flash_decode"] = dict(dec[1], exact_probe_max_abs_err=k3_probe_err, tile_body_lq16=dec[16])
    stats = _d128_stats()
    for name in lines:
        lines[name]["registers_and_local_bytes"] = stats[name]
    RESULTS["timings"]["head_dim_128"] = lines
    return lines


# ---------------------------------------------------------------------------
# phases 11-13: the LLaMA family, training LLaMA-1b and serving LLaMA-7b
# ---------------------------------------------------------------------------
def llama_train_phase(seed: int, card: str, warmup: int = 2, steps: int = 10):
    """LLaMA-1b through ``initialize`` and ``train_batch``: micro-batch 4 at
    seq 2048, bf16 over fp32 masters, remat, the fused head on the untied
    [E, V] kernel, the flash backend, AdamW lr 1e-4 wd 0.01, clipping 1.0,
    one seeded batch repeated."""
    from deepspeed_tpu_torch import LlamaForCausalLM, get_llama_config, initialize
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches

    micro, seq = 4, 2048
    cfg = get_llama_config("1b", remat=True, attention_backend="flash", dtype=torch.bfloat16,
                           fused_head_loss_chunk=1024)
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    engine, _, _, _ = initialize(model=model, config=train_config(micro, 1.0, True))
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (micro, seq)).astype(np.int32)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts zeroed just before, read just after ----
    reset_launches()
    losses = [engine.train_batch(batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [engine.train_batch(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launches()
    # ---- end of the main path ----

    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"LLaMA training: losses not finite and falling: {losses}")
    per_step = {k: c / (warmup + steps) for k, c in counts.items()}
    layers = cfg.num_hidden_layers
    if per_step["flash_fwd"] != 2 * layers or per_step["flash_bwd"] != layers:
        raise AssertionError(f"LLaMA training: expected K1 {2 * layers} (forward, remat recompute) and "
                             f"K4 {layers} launches per step, got {per_step}")
    step_ms = dt / steps * 1e3
    tokens_s = micro * seq * steps / dt
    fpt = flops_per_token(n_params, layers, cfg.hidden_size, seq)
    out = dict(n_params=n_params, losses=losses, launches=counts, launches_per_step=per_step,
               step_ms=step_ms, tokens_per_s=tokens_s, model_tflops=fpt * tokens_s / 1e12,
               flops_per_token=fpt, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               grad_norm=engine.get_global_grad_norm())
    log(f"llama train: LLaMA-1b ({n_params} params), seq {seq}, micro-batch {micro}, bf16, remat, fused "
        f"[E, V] head, flash; losses {losses[0]:.4f} -> {losses[-1]:.4f} over {warmup}+{steps} steps  [{card}]")
    log(f"llama train: {step_ms:.2f} ms/step, {tokens_s:.1f} tokens/s, {out['model_tflops']:.2f} model "
        f"TFLOP/s ({fpt:.4g} FLOP/token), peak memory {out['peak_memory_gb']:.2f} GB  [{card}]")
    log(f"llama train launches on the main path: {counts}; per step {per_step}  [{card}]")
    out["profile"] = _profile_train_step(engine, batch, card, step_ms)
    return out, counts


def _llama_gradcheck(name: str, cfg_kw: dict, batch: int, seq: int, seed: int) -> dict:
    """:func:`gradcheck` of a LLaMA model (remat, flash, the fused head)."""
    from deepspeed_tpu_torch import LlamaForCausalLM, get_llama_config

    kw = dict(remat=True, attention_backend="flash", fused_head_loss_chunk=1024, **cfg_kw)
    base = LlamaForCausalLM(get_llama_config("test", **kw), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(seed + 2))
    state = {k: v.detach().cpu() for k, v in base.state_dict().items()}
    del base
    ids = np.random.default_rng(seed + 2).integers(0, kw["vocab_size"], (batch, seq)).astype(np.int32)
    return gradcheck(f"llama gradcheck {name}", lambda device, dtype: LlamaForCausalLM(
        get_llama_config("test", dtype=dtype, **kw), device=device), state, ids)


def llama_gradcheck_phase(seed: int, card: str) -> dict:
    """(a) LLaMA-1b's width at 2 layers, batch 2 x seq 512; (b) Mistral-7b's
    width at 2 layers (GQA 32/8, FFN 14336) with ``sliding_window``
    overridden from 4096 to 256 at seq 1024, batch 1, so that the window
    mask bites in K1 and K4."""
    from deepspeed_tpu_torch.models.llama import LLAMA_CONFIGS

    def width(preset, **over):
        keep = ("vocab_size", "hidden_size", "intermediate_size", "num_attention_heads",
                "num_key_value_heads", "rope_theta", "sliding_window")
        return dict({k: v for k, v in LLAMA_CONFIGS[preset].items() if k in keep}, vocab_size=32000,
                    num_hidden_layers=2, **over)

    out = {"llama_1b_width": _llama_gradcheck("(a) LLaMA-1b width", dict(width("1b"), max_position_embeddings=512),
                                              2, 512, seed)}
    torch.cuda.empty_cache()
    out["mistral_7b_width_window_256"] = _llama_gradcheck(
        "(b) Mistral-7b width, window 256", dict(width("mistral-7b", sliding_window=256),
                                                 max_position_embeddings=1024), 1, 1024, seed)
    return out


def _profile_generate(engine, prompts: np.ndarray, card: str, new_tokens: int = 9) -> dict:
    """Device busy time against the wall of one ``generate`` of
    ``new_tokens`` after one 16-token prefill chunk (so mostly token
    steps), from ``torch.profiler``'s device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    families = {}
    for e in events:
        family = next((f for f, keys in TRAIN_KERNEL_FAMILIES + SERVE_KERNEL_FAMILIES
                       if any(k in e.key for k in keys)), "other (elementwise, reductions, copies)")
        families[family] = families.get(family, 0.0) + e.self_device_time_total / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms if events else None,
           "device_idle_share": 1.0 - busy_ms / wall_ms if events else None,
           "device_ms_by_family": families}
    if events:
        log(f"llama serve profile of generate({new_tokens} tokens after 16): wall {wall_ms:.2f} ms under "
            f"the profiler, device busy {busy_ms:.2f} ms, idle share {out['device_idle_share']:.3f}; "
            + ", ".join(f"{f} {ms:.2f} ms" for f, ms in sorted(families.items(), key=lambda kv: -kv[1]))
            + f"  [{card}]")
    return out


def llama_serving_phase(seed: int, card: str):
    """LLaMA-7b (32 layers, 32 heads of 128, cache 2048, bf16, random seeded
    weights) through ``init_inference(kernel_inject=True,
    use_flash_prefill=True)``: ``forward`` on [4, 2048] and ``generate`` of
    64 greedy tokens for 4 prompts of 512, launch counts zeroed just before
    and read just after (K1 and K3 must launch); then the first prefill
    chunk's and the first decode step's logits at 2 layers of full width on
    the card against the CPU, as phase 4 (c) holds them."""
    from deepspeed_tpu_torch import LlamaForCausalLM, get_llama_config, init_inference
    from deepspeed_tpu_torch.models.common import init_cache
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    cfg = get_llama_config("7b", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    engine = init_inference(model, dtype="bf16", kernel_inject=True, use_flash_prefill=True)
    del model
    torch.cuda.empty_cache()
    if engine.module.config.attention_backend != "flash":
        raise AssertionError("kernel injection did not select the flash backend")
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4, 2048)), device="cuda")
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 512))
    engine.generate(prompts[:, :32], max_new_tokens=2)  # warm-up: cuBLAS handles, kernels loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts zeroed just before, read just after ----
    reset_launches()
    t0 = time.perf_counter()
    logits = engine.forward(tokens)
    torch.cuda.synchronize()
    out["forward_s"] = time.perf_counter() - t0
    if logits.shape != (4, 2048, cfg.vocab_size) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"forward: bad logits {tuple(logits.shape)}")
    del logits
    forward_counts = launches()
    t0 = time.perf_counter()
    first = engine.generate(prompts, max_new_tokens=1)
    ttft = time.perf_counter() - t0
    t0 = time.perf_counter()
    generated = engine.generate(prompts, max_new_tokens=64)
    gen_s = time.perf_counter() - t0
    counts = launches()
    # ---- end of the main path ----

    if tuple(generated.shape) != (4, 512 + 64) or not (generated[:, :512].numpy() == prompts).all():
        raise AssertionError(f"generate: bad output {tuple(generated.shape)}")
    if not torch.equal(generated[:, :513], first):
        raise AssertionError("generate: the first token differs between the 1-token and 64-token runs")
    missing = [k for k in ("flash_fwd", "flash_decode") if counts[k] <= 0]
    if missing or forward_counts["flash_fwd"] != cfg.num_hidden_layers:
        raise AssertionError(f"LLaMA serving: kernels not launched as expected: forward {forward_counts}, "
                             f"all {counts}")
    # prefill: 512 / 16 chunks, then 63 decode steps, each through every layer
    want_k3 = (512 // 16 + 63 + 512 // 16) * cfg.num_hidden_layers
    if counts["flash_decode"] != want_k3:
        raise AssertionError(f"LLaMA serving: K3 launched {counts['flash_decode']} times, expected {want_k3}")
    out.update(launches=counts, forward_launches=forward_counts, generate_s=gen_s, ttft_s=ttft,
               ms_per_token=(gen_s - ttft) / 63 * 1e3, tokens_per_s=4 * 64 / gen_s,
               forward_tokens_per_s=4 * 2048 / out["forward_s"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"llama serve: LLaMA-7b bf16 forward [4,2048] {out['forward_s']:.3f} s "
        f"({out['forward_tokens_per_s']:.1f} tokens/s); generate 4x64 after 512-token prompts "
        f"{gen_s:.3f} s: {out['tokens_per_s']:.1f} tokens/s, {out['ms_per_token']:.2f} ms per token step, "
        f"TTFT {ttft * 1e3:.1f} ms  [{card}]")
    log(f"llama serve launches on the main path: {counts}")
    out["profile"] = _profile_generate(engine, prompts[:, :16], card)
    del engine
    torch.cuda.empty_cache()

    # the first prefill chunk and decode step at 2 layers of full width
    small = get_llama_config("7b", num_hidden_layers=2, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                             attention_backend="flash")
    base = LlamaForCausalLM(small, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed + 4))
    state = {k: v.detach().cpu() for k, v in base.state_dict().items()}
    del base
    ids = torch.as_tensor(prompts[:, :16])
    runs = {}
    for name, device, dtype in (("served_bf16", "cuda", torch.bfloat16), ("plain_bf16", "cpu", torch.bfloat16),
                                ("served_fp32", "cuda", torch.float32), ("plain_fp32", "cpu", torch.float32)):
        m = LlamaForCausalLM(dataclasses.replace(small, dtype=dtype, param_dtype=dtype), device=device)
        m.load_state_dict({k: v.to(dtype) for k, v in state.items()}, strict=True)
        with torch.inference_mode():
            cache = init_cache(m, 4)
            prefill = m(ids.to(device), cache)[:, -1].float().cpu()
            nxt = prefill.argmax(-1) if name == "served_bf16" else runs["served_bf16"]["next"]
            decode = m(nxt[:, None].to(device), cache)[:, 0].float().cpu()
        runs[name] = {"prefill": prefill, "decode": decode, "next": nxt}
        del m, cache
    for tick in ("prefill", "decode"):
        compare(f"llama serve {tick} logits fp32 (card vs plain)", runs["served_fp32"][tick],
                runs["plain_fp32"][tick], torch.float32)
        rounding = rel_err(runs["plain_bf16"][tick], runs["plain_fp32"][tick])[1]
        out[f"{tick}_bf16_rounding_rel"] = rounding
        compare(f"llama serve {tick} logits bf16 (card vs plain, 1.5x rounding)", runs["served_bf16"][tick],
                runs["plain_bf16"][tick], torch.bfloat16, tol=1.5 * rounding)
    return out, counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="all",
                    help="'all' (the default: every phase and the kernels line), or a comma list of "
                         "'times' (K2's and K3's value-form timings alone) and 'serving' (phase 4), "
                         "which use only the API earlier commits share, so that copied into an "
                         "earlier checkout this script measures that commit the same way")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= {"all", "times", "serving"} or ("all" in phases and len(phases) > 1):
        ap.error(f"--phases takes 'all' or a comma list of 'times' and 'serving', got {args.phases!r}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import deepspeed_tpu_torch  # noqa: F401  (fails in a directory without the package)
    from deepspeed_tpu_torch.ops.cuda import build

    # full-precision library products: fp32 stays fp32 (no TF32) and bf16
    # GEMMs reduce in fp32, as the kernels and their plain versions do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; device {kind}")
    RESULTS.update(card=card, device=kind, torch=torch.__version__)
    t0 = time.perf_counter()
    per = build.build(verbose=True)
    RESULTS["build_s"] = time.perf_counter() - t0
    log(f"build: {RESULTS['build_s']:.1f} s wall ({', '.join(f'{k} {v:.1f} s' for k, v in per.items())})")
    if "all" not in phases:
        if "times" in phases:
            times = kernel_times(torch.Generator(device="cuda").manual_seed(args.seed))
            del times["k3_ops"]
            RESULTS["timings"] = times
            for key, t in times["flash_decode"].items():
                log(f"time flash_decode {key}: kernel_ms={t['ms']:.4f} kernel_device_ms={t['device_ms']:.4f} "
                    f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f}")
        if "serving" in phases:
            RESULTS["slice"] = slice_phase(args.seed, card)[0]
    else:
        phase_s = {}
        t_phase = time.perf_counter()
        lines = kernel_phase(torch.Generator(device="cuda").manual_seed(args.seed), args.seed)
        lines_d128 = kernel_phase_d128(torch.Generator(device="cuda").manual_seed(args.seed + 100), args.seed)
        phase_s["3 kernels"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        RESULTS["slice"], serve_counts = slice_phase(args.seed, card)
        phase_s["4 serving"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        for tick in ("prefill_profile", "profile"):
            split = RESULTS["slice"][tick]["busy_ms_per_tick_by_kernel"]
            if split is not None and split["KV dequantise"] > 0:
                raise AssertionError(f"the int8 KV pool is still dequantised before K3 ({tick}: {split})")
        RESULTS["train"], train_counts = train_phase(args.seed, card)
        RESULTS["gradcheck"] = gradcheck_phase(args.seed, card)
        torch.cuda.empty_cache()
        RESULTS["moe_train"], moe_counts, moe_engine, moe_batch = moe_train_phase(args.seed, card)
        gate_stats = _check_gate_stats(moe_engine, moe_batch, card)  # phase 10 (e), on this engine
        del moe_engine
        torch.cuda.empty_cache()
        RESULTS["moe_gradcheck"] = moe_gradcheck_phase(args.seed, card)
        torch.cuda.empty_cache()
        RESULTS["sparse"], sparse_counts = sparse_phase(args.seed, card)
        torch.cuda.empty_cache()
        RESULTS["engine_api"], api_counts = engine_api_phase(args.seed, card)
        RESULTS["engine_api"]["e_moe_gate_stats"] = gate_stats
        phase_s["5-10 training, MoE, sparse, engine API"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        RESULTS["llama_train"], llama_train_counts = llama_train_phase(args.seed, card)
        phase_s["11 LLaMA-1b training"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        RESULTS["llama_gradcheck"] = llama_gradcheck_phase(args.seed, card)
        phase_s["12 LLaMA gradcheck"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        RESULTS["llama_serve"], llama_serve_counts = llama_serving_phase(args.seed, card)
        phase_s["13 LLaMA-7b serving"] = time.perf_counter() - t_phase
        RESULTS["phase_s"] = phase_s
        log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    RESULTS["total_s"] = time.perf_counter() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"chip_smoke_seed{args.seed}.json"), "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)
    if "all" in phases:
        # launches: the serving, training, MoE training, sparse attention,
        # engine API, LLaMA training and LLaMA serving paths' counts, each
        # zeroed just before its path and read just after. K1, K4 and K3
        # also carry their head-dim-128 entry (the LLaMA shapes), with the
        # launches of the LLaMA paths, which run at head dim 128 only.
        paths = (serve_counts, train_counts, moe_counts, sparse_counts, api_counts,
                 llama_train_counts, llama_serve_counts)
        llama_paths = (llama_train_counts, llama_serve_counts)
        kernels = []
        for name in ("flash_fwd", "quant_matmul", "flash_decode", "flash_bwd", "moe_permute",
                     "sparse_fwd", "sparse_bwd"):
            entry = dict({k: v for k, v in lines[name].items() if k in KERNEL_LINE_KEYS},
                         launches=sum(c.get(name, 0) for c in paths), head_dims=HEAD_DIMS[name])
            if name in lines_d128:
                entry["at_head_dim_128"] = dict(
                    {k: v for k, v in lines_d128[name].items() if k in KERNEL_LINE_KEYS + ("shape",)},
                    launches=sum(c.get(name, 0) for c in llama_paths))
            kernels.append(entry)
        log(json.dumps({"kernels": kernels}))
    log(f"total {RESULTS['total_s']:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
