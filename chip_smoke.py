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
              must give the value form's bits on the dequantised pool) at Lq 1,
              5 (phase 14's verify block: 5 of the tile body's 16 rows live)
              and 16, and within 1e-6 of its own exact probe in both forms;
              K2's three bodies (decode M <= 16, prefill M > 16, the general
              FMA body) at every serving shape (M 8, 40 and 128: a decode
              tick, the verify block of 8 slots x 5, a prefill tick), ragged M
              and N, int8 and int4,
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
10. engine API and checkpoints — GPT-2 350m's width as in phase 5 at 8 of
              its 24 layers (1.84 GB tags), ``train_batch_size`` 16,
              micro-batch 8, ``gas`` 2: (a) 4 steps of ``train_batch``
              twice from one seeded init (the card's own bit-determinism)
              and the same 8 micro-batches through
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

14. serving at the JAX defaults — GPT-2 350m as in phase 4 (full width and
              depth, random seeded weights, bf16, int8 weights, int8 KV) through
              ``ContinuousBatchingScheduler`` with every other ``ServingConfig``
              field at its default (prefix cache on, a tick event a tick, a
              heartbeat a second): (a) 32 greedy requests from 4 templates (a
              512-token shared prefix, a 32-96-token tail, 24-40 new tokens)
              with the cache on and off at one byte budget (``kv_pool_bytes``,
              1.5x slots x context); (b) phase 4 (b)'s 16 requests with
              speculation (k 4) off (with the prefix cache off, then on: the
              default's cost on traffic that shares no prefix), on with a
              4-layer student drafter (layers
              0, 8, 16, 23 and the embeddings, ``student_initialization``), and
              on with the target's own 24 layers as the drafter (which
              accepts, so the accept and refeed paths run; its rounds must
              make one host sync each, the copy of drafts and verdicts,
              where no request retires: ``torch.cuda.set_sync_debug_mode``
              counts them; each round's launches are read around each
              step's calls); the reference run's share of positions whose
              top-2 margin is within the margin rule's limit; speculation
              at full depth in fp32 (the 24-layer drafter, fp KV) token for
              token against spec off; the first verify
              tick at 2 layers of full width, card against CPU, as (c) of
              phase 4; (c) 24 requests and a SIGTERM after 6 ticks through a
              passed guard: ``serve`` returns 143, every request in flight then
              finishes in full, every queued one is refused, the pool is free;
              (d) on (c)'s run, the telemetry JSONL (every ``serve_*`` event
              valid, a ``serve_tick`` a tick) and the heartbeat file (the
              serving role block). Launch counts are zeroed just before each
              run and read just after: K2 and K3 launch in each, and in (b)
              they equal what the tick mix implies, the drafter's counted.
              Greedy outputs of cache on and speculation on must equal the
              reference run's, or first diverge where the reference's top-2
              logit margin is within 1.5x phase 4 (c)'s measured rounding.

15. resilience — phase 10's model (350m's width at 8 layers,
              train_batch_size 16, gas 2, the ``"flash"`` backend) under the
              resilience config, a heartbeat every step: an uninterrupted
              6-step run with launch counts zeroed just before and read just
              after (K1 32 and K4 16 a step: 2 micro-batches), saving ``sync`` after step 2; (a) a ``nebula.enabled``
              engine saves ``async`` after step 2: the call returns before
              the tag is published (``latest`` still ``sync``), 3 steps run
              with the save pending, the flush publishes it, its leaf digests
              equal ``sync``'s, and loaded with ``verify_checkpoint="full"``
              it trains steps 3-6 to the uninterrupted bits; (b) a child
              (``--child preempt``) with ``preempt_save_dir`` gets SIGTERM once
              its heartbeat shows step 2, checkpoints at the next boundary and
              exits 143; a second child's ``resume()`` (no dir) trains to step
              6: losses and a sha256 of the parameters bit-equal to the
              uninterrupted run; (c) ``DSElasticAgent`` (ladder [1],
              ``max_restarts`` 2) supervises ``--child agent`` (an async save
              after each odd step, flushed after the next), whose first
              launch carries ``DS_FAULT_SPEC=step=sigkill@3``: rc -9 then 0,
              step 3's heartbeat, a ``plain`` resume from ``global_step1``,
              steps to 4 bit-equal, and the restart's seconds by part; (d)
              ``--child torn`` dies by ``ckpt_pre_rename=sigkill`` inside its
              second save: the tag is invisible and ``resume()`` restores the
              first; (e) poisoned batches (``poison_batch``,
              ``overflow_injected_loss``) under ``max_consecutive_overflows``
              3 raise ``OverflowAbort`` at the third skipped step with the
              parameters unchanged. Its checkpoints live in a temp dir,
              deleted at the end; at most three 1.84 GB tags at a time.

16. MoE serving and Mixtral — K5 on the gate's own maps at the new shapes
              (the GPT-2 350m MoE decode tick: 8 tokens into 8 experts of
              capacity 4; Mixtral training: [1, 8192, 4096] -> [1, 10240,
              4096]), exact forward and VJP, timed beside its plain version
              and ``index_select``, with the bound; (a) GPT-2 350m with 8
              experts in every other block (top-1, eval factor 2.0) through
              ``init_inference(kernel_inject=True, use_flash_prefill=True)``
              and ``ContinuousBatchingScheduler`` at the JAX defaults (int8
              weights with the experts and gate bf16, int8 KV, the prefix
              cache on) serving phase 4 (b)'s 16 requests: K2 72, K3 24 and
              K5 24 launches asserted for every decode and prefill tick, the
              rows dropped by capacity a tick, ten profiled decode ticks; the
              first prefill and decode ticks at 2 layers, card against CPU
              as phase 4 (c) holds them (the bf16 sides under the plain bf16
              run's routing, injected at the gate; the fp32 sides must route
              alike); at 2 layers in fp32, lockstep ``generate`` against the
              scheduler, one request at a time, token for token; (b)
              Mixtral-8x7B at 8 of its 32 layers, bf16: ``forward`` on [4,
              2048] and ``generate`` of 1 and 64 greedy tokens after 4
              prompts of 512, K1, K3 and K5 counts asserted, tokens/s, ms per
              token step, TTFT, peak memory, the first prefill chunk's and
              decode step's logits at 2 layers card against CPU (as (a));
              (c) Mixtral training at 1 layer (at 2, Adam's temporaries
              ran the card out of memory), seq 4096, micro-batch 1, bf16
              over fp32 masters, remat, the fused [E, V] head, AdamW,
              clipping 1.0: 2 + 10 steps, K1 2, K4 1 and K5 6 a step
              asserted, step ms, tokens/s, model TFLOP/s over the active
              parameters, peak memory, a profiled step; (d) one 2-layer
              Mixtral forward and backward at seq 256, card against CPU, every
              side under the plain bf16 step's top-2 routing: fp32 within
              1e-4, bf16 within 1.5x the measured rounding.

17. RLHF and the inference engine — GPT-2 350m (full width and depth,
              random seeded weights, bf16 over fp32 masters, the ``"flash"``
              backend) under ``initialize`` with ``hybrid_engine.enabled``
              and the JAX RLHF test's policy-gradient loss. K2 at the
              rollout's prefill tick (M 512, int8, every projection) and K3
              at the beam step (q [16,1,16,64] over a bf16 cache with 95 live
              rows) against their plain versions and timed as phase 3 times
              them (beside phase 3 when the whole script runs). (a) A
              ``RolloutLoop`` (8 slots, 64-token prefill chunks,
              64-token prompts and 64 new tokens, 2 learner steps of 8
              rollouts, a sync after each; 16 rollouts, cut from 32 for the
              script's limit) at ``weight_dtype`` int8 (K2) and fp (cohort by
              cohort, ``align_cohorts``), launch counts zeroed just before
              each run and read just after: finite losses, sync generation
              2, every fp sync
              digest-verified; rollout tokens/s, learner ms a step,
              ``execute_s`` and ``digest_s`` a sync, five profiled rollout
              ticks (idle share), peak memory; a mid-decode swap of the same
              weights token-identical; train -> generate -> train with the
              loss bits of train -> train over 3 steps (from one snapshot);
              the fp run again with a flag after learner step 1 drains with
              nothing dropped, checkpoints once and exits 143, and a fresh
              engine's ``resume`` and ``restore`` finish with the
              uninterrupted fp run's loss bits. (b) ``generate(num_beams=
              4)`` at batch 4, prompt 64, 32 new, after a ``forward``: the
              flash engine in fp32 token-identical to the ``"xla"`` engine
              on the same weights; in bf16 equal, or within the margin rule
              applied to the beams' fp32 scores (4x 1.5x the measured
              rounding times max |logit|), with the share of the
              reference's positions inside the rule printed; tokens/s, K1
              and K3 launches. (c) ``init_inference(dtype="int8")`` and
              ``quant={"enabled": True}``: int8 leaves on the card, logits
              correlation with the bf16 engine > 0.99 and top-1 agreement
              >= 0.5, weight bytes against bf16's, a ``generate``. (d) the
              preempted engine of (a) has saved its tag; it saves its 16-bit
              npz, and ``init_inference(checkpoint=)`` by directory and by
              ``{"checkpoint_dir", "tag"}`` serves its live parameters'
              fp32 logits within 1e-5, the npz the live parameters rounded
              to bf16 within 1e-5; save and load seconds.
              (e) ``PagedKVCache`` (int8 pages of 16, 16 heads of 64): 3
              sequences appended across page edges, gathered, K3 on the
              view against its plain version. Its tags live in a temp dir,
              deleted at the end.
18. the serving fleet — GPT-2 350m (full width and depth, random seeded
              weights) behind ``inference.fleet.FleetRouter``, 16 greedy
              requests submitted at once (prompts of 64-512 tokens from 4
              shared 256-token prefixes, 64 new tokens each; cut from 32
              for the script's time limit). (a) Two
              ``LocalReplica``s over schedulers of 8 slots (int8 weights,
              int8 KV, the prefix cache on: the rest ``ServingConfig``'s
              defaults), in bf16: one replica gets a SIGTERM once it holds 4
              requests in flight beside a peer with 2 free slots and an
              empty queue (its in-flight KV migrates through a
              digest-verified bundle), and in a second run a SIGKILL (its
              work is re-admitted); in fp32 the SIGTERM again. Every
              request completed, none failed, no duplicate completion, at
              least one request migrated (SIGTERM) or re-admitted
              (SIGKILL); every restored row, codes and scales, read back
              from the peer's pool equals the exported bytes bit for bit;
              the tokens against one uninterrupted
              scheduler's: fp32 identical, bf16 by phase 14's margin rule
              (the count of differing positions printed); K2 and K3 launches
              read around the peer's ticks after the signal; the migration's
              seconds by part (export, ``save_bundle``, ``load_bundle``,
              restore) and bytes per request; TTFT p50/p99 from submission,
              migrated requests and the rest; 10 router steps after the
              SIGKILL profiled (the device's idle share). Every K2 and K3
              call shape the SIGTERM runs gave after the signal (bf16 and
              fp32) is held
              against its plain version and timed beside its plain version,
              a library call and its bound. (b) Three worker processes
              (``python -m deepspeed_tpu_torch.inference.fleet.worker``,
              fp32 weights from the worker's fixed seed, int8 KV, the flash
              backend, 8 slots, n_positions 1024) started at once on the
              card, each one's seconds to ``ready`` logged: one serves the
              trace alone, two serve it together (the fleet's tokens/s, 1
              worker against 2), then those two again with a real SIGTERM
              to one mid-flight (the first 8 requests go out alone, 4 a
              worker; the rest once the peer has admitted the bundle; exit
              143, its 4 requests verified and admitted by the peer); each run's tokens identical to an in-process
              scheduler built by the worker's own ``build_scheduler``. (c)
              The autoscaler's decisions during (b), made from the pipe
              signals, equal their replay from the workers' ``serve_tick``
              telemetry, and each surviving worker's last ``serve_tick``
              equals its last pipe signals (``signals_from_telemetry``).

A device time that ``torch.profiler`` fails to record (its profiles have
come back empty on the card, early and late in a run) is timed with CUDA
events instead and logged; in the run's JSON and the ``kernels`` line such
a value has ``<key>_source: "events"`` beside it, and its path is listed
under ``profiler_fallbacks``.

It prints the ``kernels`` JSON line and the card line before the last line,
which is ``{"ok": true, "device": {...}}``. ``--phases times,serving`` runs
only K2's and K3's value-form timings and phase 4, through the API that
earlier commits share: copied into an earlier checkout, the script measures
that commit the same way (no ``kernels`` line then); ``--phases
kernels,defaults`` runs phase 3 at head dim 64, phase 4 and phase 14, ``--phases
resilience`` phase 15 alone, ``--phases moe`` phase 16 alone, ``--phases rlhf`` phase 17
alone, ``--phases fleet`` phase 4 and phase 18. Details go to
``chiprun_out/chip_smoke_seed<N>.json``. It exits non-zero, printing no result, when
CUDA is unavailable or the package is missing.
"""

import time

#: when this process began to run the script (phase 15 times a restart by part)
MODULE_T0 = time.time()

import argparse
import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and bf16 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
#: and fp32 FLOP/s outside the tensor cores
PEAK_FP32_FLOP_S = 67e12

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
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_ms_source", "library_ms_source")


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


class ProfilerEmpty(AssertionError):
    """``torch.profiler`` recorded no device time in any attempt."""


def device_times(fn, iters: int = 5, warmup: int = 2, attempts: int = 5) -> dict:
    """Device time per call of ``fn`` by kernel name: each kernel's time
    over ``iters`` calls under ``torch.profiler``, divided by ``iters``.
    Unlike events around host-issued calls (``time_ms``), launch gaps and
    host work between the kernels do not count. Profiling the CUDA
    activity alone sometimes came back with no device event at all on an
    H100, for a call whose kernels had just run; with the CPU activity
    beside it that was not seen, but later calls saw empty profiles with it
    too, three in a row, both early and late in a run. A profile with no
    device event is taken again, up to ``attempts`` times in all, then
    :class:`ProfilerEmpty` is raised."""
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
    raise ProfilerEmpty(f"torch.profiler recorded no device time in {attempts} profiles: the "
                        "device-side timing cannot be measured")


def short_name(key: str) -> str:
    """A profiler kernel name without its namespace and signature."""
    m = re.search(r"\w+_kernel", key)
    return m.group(0) if m else key


class EventMs(float):
    """A time that stands where a device time was asked for but
    ``torch.profiler`` recorded none: CUDA events around the calls, launch
    gaps and host work between the kernels included."""


def device_ms(fn, **kw) -> float:
    """Device time per call of ``fn``, all its kernels summed. When the
    profiler records nothing (:class:`ProfilerEmpty`), the call is timed with
    CUDA events instead and returned as an :class:`EventMs`, which
    :func:`tag_event_times` marks wherever it is written down."""
    try:
        return sum(device_times(fn, **kw).values())
    except ProfilerEmpty:
        ms = EventMs(time_ms(fn, iters=max(kw.get("iters", 5), 10), warmup=kw.get("warmup", 2)))
        log(f"device time not measured (the profiler stayed empty): event-timed {ms:.4f} ms instead")
        return ms


def tag_event_times(obj, path: str = "") -> None:
    """Beside every :class:`EventMs` value ``obj[key]`` of the dicts in
    ``obj`` (nested dicts and lists walked), set ``obj[key + "_source"]``
    to ``"events"`` and list the value's path under
    ``RESULTS["profiler_fallbacks"]``. A value already tagged is skipped."""
    if isinstance(obj, dict):
        for key, value in list(obj.items()):
            where = f"{path}.{key}" if path else str(key)
            if isinstance(value, EventMs):
                if f"{key}_source" not in obj:
                    obj[f"{key}_source"] = "events"
                    RESULTS.setdefault("profiler_fallbacks", []).append(where)
            else:
                tag_event_times(value, where)
    elif isinstance(obj, (list, tuple)):
        for i, value in enumerate(obj):
            tag_event_times(value, f"{path}[{i}]")


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
#: K2's timed (M, bits): a decode tick (M = 8, the drafter's too), the
#: speculation verify block (M = 8 slots x (k + 1) = 40 at k = 4) and a
#: prefill tick (M = 128)
K2_TIMED = ((8, 8), (8, 4), (40, 8), (128, 8), (128, 4))
#: K3's timed query rows: a decode tick, the verify block (k + 1 = 5) and a
#: prefill chunk
K3_LQ = (1, 5, 16)
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
    """K2 at every serving shape and K3's value form at Lq 1, 5 and 16 over
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
        for m, bits in K2_TIMED:
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
    for lq in K3_LQ:
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
    # the speculation verify block: the tile body with 5 of its 16 rows live
    k3("S=8 Lq=5 P=1024 bf16 lengths 0,1,P,P+Lq", 5, [0, 1, 4, 5, 300, 1000, P, P + 5], torch.bfloat16)
    k3("S=4 Lq=5 P=1024 fp32", 5, [5, 16, 700, P + 5], torch.float32)
    k3_errs = {(lq, mix): k3(f"S=8 Lq={lq} P=1024 bf16 {mix}", lq, lengths, torch.bfloat16)
               for lq in K3_LQ for mix, lengths in K3_MIXES.items()}
    k3_probe_err = decode_exact_probes(seed)

    # -- K2 quant matmul: every body against its plain version --------------
    def k2(m, kk, n, bits, dtype=torch.bfloat16):
        x, qw, scale, _, g = k2_operands(gen, m, kk, n, bits, dtype)
        body = qm.qmm_body(m, kk, n, kk // g, dtype == torch.bfloat16, True)
        return compare(f"quant_matmul int{bits} M={m} K={kk} N={n} {str(dtype)[6:]} ({body} body)",
                       qm.quant_matmul(x, qw, scale, bits=bits), qm.quant_matmul_plain(x, qw, scale, bits),
                       dtype)

    k2_errs = {(m, kk, n, bits): k2(m, kk, n, bits) for kk, n in K2_SHAPES for m in (8, 40, 128)
               for bits in (8, 4)}
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
    # the speculation verify block (k = 4): K3's tile body at Lq 5 and K2's
    # prefill body at M = 40, each projection
    lines["flash_decode"]["verify_block"] = times["flash_decode"]["Lq=5 serving mix int8"]
    lines["quant_matmul"]["verify_block"] = {key: t for key, t in times["quant_matmul"].items()
                                             if t["mkn_bits"][0] == 40}
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
    """K3 in bf16 and fp32, in both operand forms, at Lq 1, 5 and 16, on inputs
    whose output is exact (one-hot softmax rows, with a dead decoy key just
    past each live range, or in the next slot past a full pool, that would
    win if read: ``deepspeed_tpu_torch.testing.decode_exact_probe``): o
    within 1e-6 of the known answer, 0 where no key is live. Returns the
    largest |error|."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.testing import decode_exact_probe
    worst = 0.0
    for lq, lengths in ((1, [0, 1, 64, 65, 129, 255, 256, 257]), (5, [0, 1, 4, 5, 100, 256, 261, 250]),
                        (16, [0, 1, 15, 16, 100, 256, 272, 250])):
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
        for m in (8, 40, 128):
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
        t = k5_times(lambda: randn(1, n_rows, M, dtype=torch.bfloat16), fwd, n_rows, M)
        shape = (f"x [1,{n_rows},{M}] bf16 -> [1,{fwd.shape[1]},{M}], {t.pop('live')} live rows "
                 f"({what}, S={S} E={E} C={C})")
        timed[what] = dict(name="moe_permute", route="cuda",
                           source="deepspeed_tpu_torch/csrc/moe_permute.cu",
                           replaces="deepspeed_tpu/ops/pallas/moe_dispatch.py:76", shape=shape,
                           max_abs_err=max(errs), **t)
        log_k5_time(shape, t)
    RESULTS["timings"]["moe_permute"] = timed
    return timed["dispatch"]


def k5_times(make, fwd: torch.Tensor, n_rows: int, m: int) -> dict:
    """K5 by the map ``fwd`` [1, R] over bf16 rows [1, ``n_rows``, ``m``],
    each launch reading one of three inputs from ``make()`` so that no
    launch finds its input in the 50 MB L2 cache: K5 (event-timed and
    device-side), its plain version, ``index_select`` of the clamped index
    over the same rows (no zeroing; device-side, and event-timed), and the
    bound: the live source rows read once, every output row written, the
    index read."""
    import itertools

    from deepspeed_tpu_torch.ops.cuda import moe_dispatch as md

    copies = [make() for _ in range(3)]
    nxt = itertools.cycle(copies).__next__
    clamped = fwd[0].clamp(max=n_rows - 1).long()
    kernel = lambda: md.moe_permute(nxt(), fwd)  # noqa: E731
    library = lambda: torch.index_select(nxt()[0], 0, clamped)  # noqa: E731
    out = dict(ms=time_ms(kernel, iters=60), device_ms=device_ms(kernel, iters=30),
               plain_ms=time_ms(lambda: md.moe_permute_plain(nxt(), fwd), iters=30),
               library_event_ms=time_ms(library, iters=60), library_ms=device_ms(library, iters=30))
    live, r = int((fwd < n_rows).sum()), fwd.shape[1]
    out["bound_ms"], out["bound_by"] = bound_ms(live * m * 2 + r * m * 2 + r * 4, 0.0)
    out["live"] = live
    return out


def log_k5_time(shape: str, t: dict) -> None:
    log(f"time moe_permute {shape}: kernel_ms={t['ms']:.4f} kernel_device_ms={t['device_ms']:.4f} "
        f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} (index_select of the clamped "
        f"index, no zeroing; device-side; event-timed {t['library_event_ms']:.4f}) "
        f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")


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
@contextlib.contextmanager
def skipped_init():
    """Models built inside skip their random init, for a model whose every
    parameter and buffer a ``load_state_dict(..., strict=True)`` fills next:
    the init draws a normal for each weight on one CPU thread, about 6 s a
    billion on the host, for values the state overwrites."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, LlamaForCausalLM
    saved = {cls: cls.reset_parameters for cls in (GPT2LMHeadModel, LlamaForCausalLM)}
    for cls in saved:
        cls.reset_parameters = lambda self, generator=None: None
    try:
        yield
    finally:
        for cls, fn in saved.items():
            cls.reset_parameters = fn


def _copy_module(module, device, dtype):
    """The served model rebuilt on ``device`` with activations in ``dtype``:
    the same int8 codes and scales, float weights cast. On the CPU every
    kernel wrapper computes its plain version."""
    cfg = dataclasses.replace(module.config, dtype=dtype, param_dtype=dtype)
    with skipped_init():
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
                                              "flash_decode_kernel")),
                         ("K5 moe_permute", ("permute_kernel<",)))


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


def serving_trace(rng, vocab: int) -> list:
    """Phase 4 (b)'s 16 prompts of 32-256 tokens (phase 14 (b) serves them
    again)."""
    return [rng.integers(0, vocab, size=int(p)).astype(np.int32) for p in rng.integers(32, 257, size=16)]


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
    # the prefix cache and tick telemetry off, as the port served before it
    # had them, so that this trace's numbers compare with earlier commits'
    scfg = ServingConfig(slots=8, prefill_chunk=16, kv_quant=True, weight_dtype="int8",
                         prefix_cache="off", tick_telemetry_every=0)
    sched = ContinuousBatchingScheduler(engine, scfg)
    sched.warmup()
    rng = np.random.default_rng(seed)
    prompts = serving_trace(rng, cfg.vocab_size)
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
        with skipped_init():
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
        with skipped_init():
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
#: phase 10's model (and phase 15's): GPT-2 350m's width at 8 of its 24
#: layers, so that the whole script stays inside its time limit on a slow
#: host (the checkpoint phases are bound by the host: its hashing, writes
#: and reads of each tag, and each child process's start)
API_MODEL = dict(name="350m", n_layer=8, vocab_size=50304, n_positions=1024,
                 fused_head_loss_chunk=1024)
API_GAS = 2


def api_config() -> dict:
    """Phase 10's engine config: the training phase's at ``train_batch_size``
    16 over two micro-batches of 8, every loaded leaf re-hashed."""
    return dict(train_config(8, 1.0, True), train_batch_size=16, gradient_accumulation_steps=API_GAS,
                resilience={"verify_checkpoint": "full", "fallback_on_corruption": True})


def _api_engine(seed: int, config=None, loss_fn=None, **model_kw):
    """Phase 10's GPT-2 engine (350m's width at ``API_MODEL``'s depth;
    ``config``: default :func:`api_config`)."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, initialize
    kw = dict(API_MODEL, remat=True, dtype=torch.bfloat16)
    kw.update(model_kw)
    cfg = get_gpt2_config(kw.pop("name"), **kw)
    model = GPT2LMHeadModel(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    return initialize(model=model, config=config or api_config(), loss_fn=loss_fn, device="cuda")[0]


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
        with skipped_init():
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


# ---------------------------------------------------------------------------
# phase 14: serving at the JAX package's defaults
# ---------------------------------------------------------------------------
#: the speculation drafter: a 4-layer student of GPT-2 350m, seeded from
#: these teacher layers, with the embeddings and the final norm copied
DRAFTER_LAYERS = [0, 8, 16, 23]
SPEC_K = 4
#: K2 launches per GPT-2 layer and call (QKV, attention out, MLP in, MLP out)
K2_PER_LAYER = 4


def drafter_recipe() -> dict:
    return {"compression_training": {"layer_reduction": {
        "enabled": True, "module_name_prefix": "h", "teacher_layer": DRAFTER_LAYERS,
        "other_module_name": ["wte", "wpe", "ln_f"]}}}


def prefix_trace(rng, vocab: int, n: int, templates: int = 4, prefix: int = 512) -> list:
    """``n`` greedy requests from ``templates`` prompt templates: a shared
    ``prefix``-token system prompt, a 32-96-token tail and 24-40 new tokens
    each (jittered, so that the cache-off arm does not prefill in lockstep
    waves)."""
    shared = [rng.integers(0, vocab, size=prefix).astype(np.int32) for _ in range(templates)]
    trace = []
    for _ in range(n):
        tail = rng.integers(0, vocab, size=int(rng.integers(32, 97))).astype(np.int32)
        trace.append((np.concatenate([shared[int(rng.integers(0, templates))], tail]),
                      int(rng.integers(24, 41))))
    return trace


def first_divergence(a, b):
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def check_lossless(what: str, module, trace, ref, got, rounding: float, card: str) -> dict:
    """Greedy outputs ``got`` against the reference run's ``ref`` (cache
    off, speculation off): equal, or each request's first divergence falls
    where the reference's top-2 logit margin is within 1.5x the rounding
    this run measured (phase 4 (c): max |plain bf16 - plain fp32| over max
    |logits|, times max |logits| at that position). The reference's logits
    there come from a full forward of the served module over the prompt and
    the reference's tokens before the position."""
    rows = []
    for i, ((prompt, _), a, b) in enumerate(zip(trace, ref, got)):
        j = first_divergence(a, b)
        if j is None:
            continue
        ids = np.concatenate([prompt, np.asarray(a[:j], np.int32)]).astype(np.int64)[None]
        with torch.inference_mode():
            logits = module(torch.as_tensor(ids, device="cuda"))[0, -1].float()
        top = logits.topk(2).values
        margin, limit = (top[0] - top[1]).item(), 1.5 * rounding * logits.abs().max().item()
        rows.append(dict(request=i, position=j, margin=margin, limit=limit, ok=margin <= limit))
    ok = all(r["ok"] for r in rows)
    RESULTS["checks"].append({"name": f"{what}: lossless (margin rule)", "divergent": rows, "ok": ok})
    log(f"check {what}: {len(trace) - len(rows)}/{len(trace)} requests token-identical; first "
        f"divergences {[(r['request'], r['position'], round(r['margin'], 4), round(r['limit'], 4)) for r in rows]} "
        f"(request, position, top-2 margin, 1.5x rounding) {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        raise AssertionError(f"{what}: a divergence where the reference's margin exceeds 1.5x the "
                             f"rounding: {rows}")
    return {"identical": len(trace) - len(rows), "divergent": rows}


def margin_share(module, trace, ref, rounding: float) -> dict:
    """Over every generated position of the reference run ``ref``: how many
    have a top-2 logit margin within 1.5x ``rounding`` (the positions where
    the margin rule would let a divergence pass), and how many are exact
    ties. The logits come from one forward of ``module`` a request over its
    prompt and its reference tokens."""
    within = ties = total = 0
    for (prompt, _), out in zip(trace, ref):
        ids = np.concatenate([prompt, np.asarray(out[:-1], np.int32)]).astype(np.int64)[None]
        with torch.inference_mode():
            logits = module(torch.as_tensor(ids, device="cuda"))[0, len(prompt) - 1:].float()
        top = logits.topk(2, dim=-1).values
        margin = top[:, 0] - top[:, 1]
        within += int((margin <= 1.5 * rounding * logits.abs().amax(-1)).sum())
        ties += int((margin == 0).sum())
        total += margin.numel()
    return dict(positions=total, within_limit=within, exact_ties=ties, share_within_limit=within / total)


def _read_launches(fn, into: list):
    """Wrap the step ``fn``: the launch counts of each call, zeroed just
    before it and read just after, are appended to ``into`` and added back
    to the counts of the run around it."""
    from deepspeed_tpu_torch.ops.cuda import LAUNCHES, launches, reset_launches

    def wrapped(*args):
        before = launches()
        reset_launches()
        try:
            return fn(*args)
        finally:
            got = launches()
            into.append(got)
            for name, n in before.items():
                LAUNCHES[name] = n + got[name]

    return wrapped


def _round_launches(sched) -> list:
    """Read the launches of each speculation round's steps (the target's
    verify, the drafter's k decodes and its refeed) around each call;
    returns the list the rounds are appended to, one ``{step: [counts of
    each call]}`` a round."""
    rounds: list = []
    calls = {"target verify": [], "drafter decode": [], "drafter refeed": []}
    sched.fns = dict(sched.fns, verify=_read_launches(sched.fns["verify"], calls["target verify"]))
    sched.dfns = dict(sched.dfns, decode=_read_launches(sched.dfns["decode"], calls["drafter decode"]),
                      verify=_read_launches(sched.dfns["verify"], calls["drafter refeed"]))
    orig = sched._spec_tick

    def spec_tick(slots):
        for v in calls.values():
            v.clear()
        orig(slots)
        rounds.append({step: [dict(c) for c in v] for step, v in calls.items()})

    sched._spec_tick = spec_tick
    return rounds


def per_round_launches(rounds: list) -> dict:
    """The launch counts a round measured, by step (its calls in the round
    summed) and kernel: the distinct values over the rounds that ran the
    step."""
    out: dict = {}
    for rnd in rounds:
        for step, calls in rnd.items():
            if calls:
                for name in ("quant_matmul", "flash_decode"):
                    out.setdefault(step, {}).setdefault(name, set()).add(sum(c[name] for c in calls))
    return {step: {name: sorted(v) for name, v in d.items()} for step, d in out.items()}


def _timed_ticks(sched) -> dict:
    """Wrap ``sched.step`` to time each tick by kind (a tick ends at its
    host sync)."""
    times: dict = {}
    orig = sched.step

    def step(admit: bool = True):
        t0 = time.perf_counter()
        kind = orig(admit=admit)
        times.setdefault(kind, []).append(time.perf_counter() - t0)
        return kind

    sched.step = step
    return times


def _timed_calls(obj, name: str) -> list:
    """Wrap the method ``name`` of ``obj`` to time each call on the host
    clock; returns the list the seconds are appended to."""
    times: list = []
    orig = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kw)
        finally:
            times.append(time.perf_counter() - t0)

    setattr(obj, name, timed)
    return times


def _calls_ms(times: list) -> dict:
    return dict(calls=len(times), total_ms=sum(times) * 1e3,
                mean_ms=float(np.mean(times)) * 1e3 if times else None,
                max_ms=max(times) * 1e3 if times else None)


class GcTimer:
    """Python's garbage collections (count, host ms, full ones) while
    installed: a pause inside a tick is host time the card waits."""

    def __init__(self):
        self.ms, self.count, self.full, self._t0 = 0.0, 0, 0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.count += 1
            self.full += info["generation"] == 2

    def __enter__(self):
        import gc
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self)


def _count_syncs(sched) -> list:
    """Wrap ``sched._spec_tick`` to count each round's synchronizing CUDA
    calls (``torch.cuda.set_sync_debug_mode``), beside whether a request
    retired in it (a retirement copies its KV rows to the host, one copy a
    leaf)."""
    import warnings
    rounds = []
    orig = sched._spec_tick

    def spec_tick(slots):
        finished = len(sched.finished)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                orig(slots)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        rounds.append((sum("synchroniz" in str(w.message) for w in caught), len(sched.finished) > finished))

    sched._spec_tick = spec_tick
    return rounds


def _serve_run(what: str, engine, scfg, trace, card: str, drafter=None, telemetry=None,
               guard=None, on_tick=None, count_syncs=False, prepare=None):
    """Serve ``trace`` through a fresh scheduler at ``scfg``, warmed up
    first (then handed to ``prepare``, when given), launch counts zeroed
    just before ``serve`` and read just after. ``what`` names the run in the
    log, its phase first. Returns (the scheduler, its requests, the run's
    numbers)."""
    from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler, Request
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches

    sched = ContinuousBatchingScheduler(engine, scfg, drafter=drafter, telemetry=telemetry)
    sched.warmup()
    tick_s = _timed_ticks(sched)
    if on_tick is not None:
        timed = sched.step

        def step(admit: bool = True):
            kind = timed(admit=admit)
            on_tick(sched)
            return kind

        sched.step = step
    rounds = _round_launches(sched) if sched.spec_k else []
    if prepare is not None:
        prepare(sched)
    publish, kv_rows = _timed_calls(sched, "_publish_prefix"), _timed_calls(sched, "_kv_rows")
    restore = _timed_calls(sched, "_restore_prefix")
    syncs = _count_syncs(sched) if count_syncs else None
    reqs = [Request(p, max_new_tokens=n) for p, n in trace]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with GcTimer() as gc_time:
        rc = sched.serve(reqs, guard=guard)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    missing = [k for k in ("quant_matmul", "flash_decode") if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing} ({counts})")
    st = sched.stats()
    # exact percentiles over the requests (the scheduler's histogram
    # interpolates within x2 buckets)
    ttfts = [r.ttft for r in reqs if r.ttft is not None]
    gaps = [b - a for r in reqs for a, b in zip(r.token_times, r.token_times[1:])]
    out = dict(rc=rc, wall_s=wall, generated_tokens=st["generated_tokens"],
               tokens_per_s=st["generated_tokens"] / wall, ticks=st["ticks"],
               ms_per_tick={k: float(np.mean(v)) * 1e3 for k, v in tick_s.items()},
               ttft_p50_ms=float(np.percentile(ttfts, 50)) * 1e3,
               ttft_p99_ms=float(np.percentile(ttfts, 99)) * 1e3,
               per_token_p50_ms=float(np.percentile(gaps, 50)) * 1e3 if gaps else None,
               per_token_p99_ms=float(np.percentile(gaps, 99)) * 1e3 if gaps else None,
               cached_prefix_tokens=st["cached_prefix_tokens"], pool=st["pool"], launches=counts,
               publish=_calls_ms(publish), publish_copies=_calls_ms(kv_rows), restore=_calls_ms(restore),
               gc=dict(collections=gc_time.count, full=gc_time.full, ms=gc_time.ms))
    if sched.spec_k:
        out.update(rounds=len(rounds), refeeds=sum(1 for r in rounds if r["drafter refeed"]),
                   launches_per_round=per_round_launches(rounds))
    if syncs is not None:
        # the round's one host sync is the copy of drafts and verdicts
        quiet = sorted({n for n, retired in syncs if not retired})
        out["host_syncs_per_round"] = dict(without_retirement=quiet,
                                           with_retirement=sorted({n for n, retired in syncs if retired}))
        if quiet != [1]:
            raise AssertionError(f"{what}: host syncs in a round without a retirement: {quiet}, not [1]")
    for key in ("spec_k", "drafted", "accepted", "acceptance_rate"):
        if key in st:
            out[key] = st[key]
    log(f"phase {what}: rc {rc}, {out['generated_tokens']} tokens in {wall:.3f} s, "
        f"{out['tokens_per_s']:.1f} tokens/s, ticks {st['ticks']}, ms/tick "
        f"{ {k: round(v, 2) for k, v in out['ms_per_tick'].items()} }, TTFT p50/p99 "
        f"{out['ttft_p50_ms']:.1f}/{out['ttft_p99_ms']:.1f} ms, "
        f"cached prefix tokens {st['cached_prefix_tokens']}, hit rate {st['pool']['prefix_hit_rate']}, "
        f"evictions {st['pool']['prefix_evictions']}, publish {out['publish']['calls']} calls "
        f"{out['publish']['total_ms']:.1f} ms (host copies {out['publish_copies']['calls']} calls "
        f"{out['publish_copies']['total_ms']:.1f} ms), restore {out['restore']['calls']} calls "
        f"{out['restore']['total_ms']:.1f} ms, garbage collections {gc_time.count} "
        f"({gc_time.full} full) {gc_time.ms:.1f} ms, launches {counts}"
        + (f", acceptance {st['acceptance_rate']:.3f} ({st['accepted']}/{st['drafted']}), refeeds "
           f"{out['refeeds']} of {out['rounds']} rounds, launches a round {out['launches_per_round']}"
           if sched.spec_k else "") + f"  [{card}]")
    return sched, reqs, out


def _verify_tick(module, ids, block, device, kv_quant):
    """The first prefill chunk (every slot from position 0), then one
    verify block right after it, through ``module``: the verify logits."""
    from deepspeed_tpu_torch.inference.serving.programs import (make_apply_fn, make_slot_cache,
                                                                stamp_lengths)
    apply_fn = make_apply_fn(module)
    cache = make_slot_cache(module, ids.shape[0], kv_quant=kv_quant)
    zeros = np.zeros(ids.shape[0], np.int64)
    apply_fn(stamp_lengths(cache, zeros), ids.to(device))
    return apply_fn(stamp_lengths(cache, zeros + ids.shape[1]), block.to(device)).cpu()


def verify_tick_check(seed: int, card: str) -> dict:
    """The first verify tick (k + 1 = 5 tokens after a 16-token chunk, 8
    slots) at 2 layers of GPT-2 350m's width, int8 weights: the served model
    on the card against the same model on the CPU (plain versions), fp32
    within 1e-4 (fp KV), bf16 as served (int8 KV) within 1.5x the rounding
    this check measures (plain bf16 against plain fp32), as phase 4 (c)."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
    from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler, ServingConfig
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    cfg = get_gpt2_config("350m", n_layer=2, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    engine = init_inference(GPT2LMHeadModel(cfg, device="cuda", generator=gen), dtype="bf16",
                            kernel_inject=True, use_flash_prefill=True)
    served = ContinuousBatchingScheduler(engine, ServingConfig(slots=8, weight_dtype="int8")).module
    rng = np.random.default_rng(seed + 14)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8, 16)))
    block = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8, SPEC_K + 1)))
    cpu = torch.device("cpu")
    logits = {}
    for name, device, dtype in (("served_bf16", torch.device("cuda"), torch.bfloat16),
                                ("plain_bf16", cpu, torch.bfloat16),
                                ("served_fp32", torch.device("cuda"), torch.float32),
                                ("plain_fp32", cpu, torch.float32)):
        module = served if name == "served_bf16" else _copy_module(served, device, dtype)
        logits[name] = _verify_tick(module, ids, block, device, kv_quant=dtype == torch.bfloat16)
    out = {}
    compare("phase 14 verify tick logits fp32 (served vs plain)", logits["served_fp32"],
            logits["plain_fp32"], torch.float32)
    out["plain_bf16_vs_plain_fp32_rel"] = rounding = rel_err(logits["plain_bf16"], logits["plain_fp32"])[1]
    out["served_bf16_vs_plain_fp32_rel"] = rel_err(logits["served_bf16"], logits["plain_fp32"])[1]
    compare("phase 14 verify tick logits bf16 (served vs plain, 1.5x rounding)", logits["served_bf16"],
            logits["plain_bf16"], torch.bfloat16, tol=1.5 * rounding)
    out["greedy_agreement"] = (logits["served_bf16"].argmax(-1) == logits["plain_bf16"].argmax(-1)
                               ).float().mean().item()
    log(f"phase 14 (b) verify tick [8,{SPEC_K + 1}] at 2 layers: rounding {rounding:.3e}, greedy "
        f"agreement served vs plain (bf16) {out['greedy_agreement']:.3f}  [{card}]")
    return out


def fp32_spec_check(engine, trace, card: str):
    """Speculation at full depth in fp32 (int8 weights, fp KV: K2's FMA
    body and K3's row body at every Lq), held token for token: the target's
    own 24 layers as the drafter (it accepts, so the accept, refeed and
    rollback paths run) with the prefix cache on, against spec off with the
    cache off. There no bf16 near-tie can flip a token, so a fault of the
    verify path fails this check. Returns (its numbers, its launch counts)."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, init_inference
    from deepspeed_tpu_torch.compression import student_initialization
    from deepspeed_tpu_torch.inference.serving import FINISHED, ServingConfig

    engine32 = init_inference(_copy_module(engine.module, torch.device("cuda"), torch.float32),
                              dtype=torch.float32, kernel_inject=True, use_flash_prefill=True)
    cfg = engine32.module.config
    full = {"compression_training": {"layer_reduction": dict(
        drafter_recipe()["compression_training"]["layer_reduction"], teacher_layer=list(range(cfg.n_layer)))}}
    d_model = GPT2LMHeadModel(cfg, device="cuda")
    drafter = (d_model, student_initialization(d_model.state_dict(), engine32.module.state_dict(), full))
    runs, outputs, total = {}, {}, {}
    for on in (False, True):
        scfg = ServingConfig(slots=8, weight_dtype="int8", kv_quant=False,
                             prefix_cache=None if on else "off", speculation={"enabled": on, "k": SPEC_K})
        sched, reqs, runs[on] = _serve_run(f"14 (b) fp32, speculation {'on, the 24-layer drafter' if on else 'off'}",
                                           engine32, scfg, trace, card, drafter=drafter if on else None)
        if not all(r.state == FINISHED and len(r.output) == n for r, (_, n) in zip(reqs, trace)):
            raise AssertionError("(b) fp32: not every request finished in full")
        outputs[on] = [list(r.output) for r in reqs]
        for k, v in runs[on]["launches"].items():
            total[k] = total.get(k, 0) + v
    same = sum(a == b for a, b in zip(outputs[False], outputs[True]))
    ok = same == len(trace) and runs[True]["accepted"] > 0 and runs[True]["refeeds"] > 0
    RESULTS["checks"].append({"name": "phase 14 (b) fp32 speculation on vs off: token-identical",
                              "identical": same, "requests": len(trace), "ok": ok})
    log(f"check phase 14 (b) fp32 speculation on (24-layer drafter, cache on) vs off (cache off): "
        f"{same}/{len(trace)} requests token-identical, acceptance {runs[True]['acceptance_rate']:.3f}, "
        f"refeeds {runs[True]['refeeds']} {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        raise AssertionError(f"(b) fp32: speculation changed the tokens of {len(trace) - same} requests, "
                             f"or accepted nothing in full")
    return dict(identical=same, runs={"off": runs[False], "on": runs[True]}), total


def measured_rounding(slice_out: dict) -> float:
    """Phase 4 (c)'s measured bf16 rounding of the served logits (plain bf16
    with int8 KV against plain fp32), the larger of its two ticks'."""
    return max(slice_out["prefill_plain_bf16_vs_plain_fp32_rel"],
               slice_out["decode_plain_bf16_vs_plain_fp32_rel"])


def defaults_phase(seed: int, card: str, rounding: float):
    """Phase 14: GPT-2 350m at full width and depth (random seeded weights,
    bf16, int8 weights, int8 KV) through ``init_inference(kernel_inject=True,
    use_flash_prefill=True)`` and ``ContinuousBatchingScheduler`` with every
    other ``ServingConfig`` field at its default (the JAX package's):
    (a) the prefix cache on against off on one shared-prefix trace at one
    byte budget; (b) speculation (k 4, a 4-layer student drafter) on against
    off on phase 4 (b)'s trace, and the first verify tick against the CPU;
    (c) the drain on SIGTERM; (d) telemetry and the heartbeat, on (c)'s run.
    ``rounding`` is phase 4 (c)'s measured bf16 rounding (the margin rule).
    Returns (its numbers, the launch counts of its runs summed)."""
    import signal

    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
    from deepspeed_tpu_torch.compression import student_initialization
    from deepspeed_tpu_torch.elasticity import HEARTBEAT_ENV, read_heartbeat
    from deepspeed_tpu_torch.inference.serving import (FINISHED, REFUSED, ServingConfig,
                                                       iter_serve_events, validate_event)
    from deepspeed_tpu_torch.runtime.resilience.signals import PreemptionGuard
    from deepspeed_tpu_torch.runtime.telemetry import TELEMETRY_FILE, RuntimeTelemetry, TelemetryConfig

    out, total = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg = get_gpt2_config("350m", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    engine = init_inference(GPT2LMHeadModel(cfg, device="cuda", generator=gen), dtype="bf16",
                            kernel_inject=True, use_flash_prefill=True)
    slots = 8

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # ---- (a) the prefix cache, on against off, at 1.5x slots x context ----
    head_dim = cfg.n_embd // cfg.n_head
    per_token = cfg.n_layer * 2 * cfg.n_head * (head_dim + 2)  # int8 codes + a bf16 scale a head
    budget = int(1.5 * slots * cfg.n_positions * per_token)
    trace = prefix_trace(np.random.default_rng(seed + 1), cfg.vocab_size, 32)
    runs = {}
    for mode in ("off", "on"):
        scfg = ServingConfig(slots=slots, weight_dtype="int8", kv_pool_bytes=budget, prefix_cache=mode)
        sched, reqs, runs[mode] = _serve_run(f"14 (a) prefix cache {mode}", engine, scfg, trace, card)
        if sched._kv_bytes_per_token() != per_token:
            raise AssertionError(f"KV bytes per token {sched._kv_bytes_per_token()} != {per_token}")
        pool = runs[mode]["pool"]
        if not all(r.state == FINISHED and len(r.output) == n for r, (_, n) in zip(reqs, trace)):
            raise AssertionError(f"(a) {mode}: not every request finished in full")
        if pool["used_blocks"] != 0 or pool["total_allocs"] != pool["total_frees"]:
            raise AssertionError(f"(a) {mode}: the pool did not return to empty: {pool}")
        runs[mode]["outputs"] = [list(r.output) for r in reqs]
        add(runs[mode]["launches"])
        if mode == "on":
            served = sched.module
    if runs["on"]["cached_prefix_tokens"] <= 0 or runs["on"]["pool"]["prefix_evictions"] != 0:
        raise AssertionError(f"(a) the cache did not hit, or thrashed: {runs['on']['pool']}")
    out["a_prefix"] = dict(kv_pool_bytes=budget, kv_bytes_per_token=per_token, runs=runs,
                           margins=margin_share(served, trace, runs["off"]["outputs"], rounding),
                           lossless=check_lossless("phase 14 (a) cache on vs off", served, trace,
                                                   runs["off"]["outputs"], runs["on"]["outputs"],
                                                   rounding, card))
    for mode in ("off", "on"):
        del runs[mode]["outputs"]
    del served, sched

    # ---- (b) speculation, k 4, a 4-layer student, on against off ----
    d_model = GPT2LMHeadModel(get_gpt2_config("350m", n_layer=len(DRAFTER_LAYERS), dtype=torch.bfloat16,
                                              param_dtype=torch.bfloat16), device="cuda")
    d_state = student_initialization(d_model.state_dict(), engine.module.state_dict(), drafter_recipe())
    # the target's own 24 layers as a drafter too: random weights give the
    # 4-layer student next to no acceptance, and this one accepts, so the
    # accept and refeed paths run on the card
    full = {"compression_training": {"layer_reduction": dict(
        drafter_recipe()["compression_training"]["layer_reduction"], teacher_layer=list(range(cfg.n_layer)))}}
    f_model = GPT2LMHeadModel(cfg, device="cuda")
    drafters = {"student": (len(DRAFTER_LAYERS), (d_model, d_state)),
                "full depth": (cfg.n_layer, (f_model, student_initialization(
                    f_model.state_dict(), engine.module.state_dict(), full)))}
    trace = [(p, 32) for p in serving_trace(np.random.default_rng(seed), cfg.vocab_size)]
    spec = {}
    # spec off with the cache off, then at the defaults (cache on): the
    # default path's cost on traffic that shares no prefix
    for on in ("cache off", False, "student", "full depth"):
        scfg = ServingConfig(slots=slots, weight_dtype="int8", prefix_cache="off" if on == "cache off" else None,
                             speculation={"enabled": on in drafters, "k": SPEC_K})
        n_d, drafter = drafters.get(on, (0, None))
        sched, reqs, spec[on] = _serve_run(
            f"14 (b) speculation {f'on, the {n_d}-layer drafter' if n_d else 'off'}"
            + (", prefix cache off" if on == "cache off" else ""), engine, scfg,
            trace, card, drafter=drafter, count_syncs=on == "full depth")
        if not all(r.state == FINISHED and len(r.output) == 32 for r in reqs):
            raise AssertionError("(b): not every request finished with 32 tokens")
        spec[on]["outputs"] = [list(r.output) for r in reqs]
        add(spec[on]["launches"])
        t = cfg.n_layer
        pre, dec, rounds = spec[on]["ticks"]["prefill"], spec[on]["ticks"]["decode"], spec[on]["ticks"]["spec"]
        if n_d:  # every prefill tick runs both models; a round k drafter decodes and one verify
            refeeds = spec[on]["refeeds"]
            want_k2 = K2_PER_LAYER * (pre * (t + n_d) + rounds * (t + SPEC_K * n_d) + refeeds * n_d)
            want_k3 = pre * (t + n_d) + rounds * (t + SPEC_K * n_d) + refeeds * n_d
            if rounds != spec[on]["rounds"]:
                raise AssertionError(f"(b) {spec[on]['rounds']} rounds read, {rounds} spec ticks")
        else:
            want_k2, want_k3 = K2_PER_LAYER * t * (pre + dec), t * (pre + dec)
        got = spec[on]["launches"]
        if (got["quant_matmul"], got["flash_decode"]) != (want_k2, want_k3):
            raise AssertionError(f"(b) launches {got} != K2 {want_k2}, K3 {want_k3} from the tick mix")
        if on == "student":
            served = sched.module
    ref = spec[False]["outputs"]
    out["b_spec"] = dict(runs={"off": spec[False], "off_cache_off": spec["cache off"], "on": spec["student"],
                               "on_full_depth": spec["full depth"]},
                         margins=margin_share(served, trace, ref, rounding),
                         lossless={on: check_lossless(f"phase 14 (b) speculation on ({on} drafter) vs off",
                                                      served, trace, ref, spec[on]["outputs"], rounding, card)
                                   for on in ("student", "full depth")})
    out["b_spec"]["lossless"]["cache off"] = check_lossless(
        "phase 14 (b) spec off: prefix cache off vs on (no shared prefix)", served, trace, ref,
        spec["cache off"]["outputs"], rounding, card)
    m = out["b_spec"]["margins"]
    log(f"phase 14 (b) reference run: {m['within_limit']} of {m['positions']} positions "
        f"({m['share_within_limit']:.3f}) have a top-2 margin within 1.5x the rounding, "
        f"{m['exact_ties']} exact ties  [{card}]")
    if spec["full depth"]["accepted"] <= 0 or spec["full depth"]["refeeds"] <= 0:
        raise AssertionError("(b) the full-depth drafter never had a draft accepted in full")
    for run in spec.values():
        del run["outputs"]
    del served, sched, d_model, d_state, f_model, drafters
    torch.cuda.empty_cache()
    out["b_fp32"], counts = fp32_spec_check(engine, trace[:8], card)
    add(counts)
    torch.cuda.empty_cache()
    out["b_verify_tick"] = verify_tick_check(seed, card)

    # ---- (c) the drain on SIGTERM, (d) telemetry and the heartbeat ----
    rng = np.random.default_rng(seed + 2)
    trace = [(p, 32) for p in serving_trace(rng, cfg.vocab_size)]
    trace += [(p, 32) for p in serving_trace(rng, cfg.vocab_size)[:8]]
    tmp = tempfile.mkdtemp(prefix="phase14_")
    beat = os.path.join(tmp, "heartbeat.json")
    telem = RuntimeTelemetry(TelemetryConfig(enabled=True, output_path=tmp, job_name="serve"))
    telem.write_run_header({"phase": 14})
    guard = PreemptionGuard(signals=["SIGTERM"]).install()
    at_signal = {}

    def on_tick(sched):
        if sum(sched.ticks.values()) == 6 and not at_signal:
            at_signal["in_flight"] = [r.request_id for r in sched.in_flight]
            at_signal["queued"] = [r.request_id for r in sched.queue.pending]
            os.kill(os.getpid(), signal.SIGTERM)

    old_beat = os.environ.get(HEARTBEAT_ENV)
    os.environ[HEARTBEAT_ENV] = beat
    try:
        scfg = ServingConfig(slots=slots, weight_dtype="int8")
        sched, reqs, drain = _serve_run("14 (c) drain on SIGTERM after 6 ticks", engine, scfg, trace, card,
                                        telemetry=telem, guard=guard, on_tick=on_tick)
    finally:
        guard.uninstall()
        if old_beat is None:
            os.environ.pop(HEARTBEAT_ENV, None)
        else:
            os.environ[HEARTBEAT_ENV] = old_beat
        telem.close()
    add(drain["launches"])
    by_id = {r.request_id: r for r in reqs}
    finished = [r for r in reqs if r.state == FINISHED]
    refused = [r for r in reqs if r.state == REFUSED]
    if drain["rc"] != 143:
        raise AssertionError(f"(c) serve returned {drain['rc']}, not 143")
    if sorted(r.request_id for r in finished) != sorted(at_signal["in_flight"]) or \
            not all(len(r.output) == 32 for r in finished):
        raise AssertionError("(c) not every request in flight at the signal finished in full")
    if sorted(r.request_id for r in refused) != sorted(at_signal["queued"]) or not refused or \
            not all("draining on SIGTERM" in by_id[i].refuse_reason for i in at_signal["queued"]):
        raise AssertionError("(c) not every queued request was refused")
    if drain["pool"]["used_blocks"] != 0 or drain["pool"]["total_allocs"] != drain["pool"]["total_frees"]:
        raise AssertionError(f"(c) the pool leaked: {drain['pool']}")
    ticks = sum(drain["ticks"].values())
    path = os.path.join(telem.run_dir, TELEMETRY_FILE)
    events = list(iter_serve_events(path))
    for rec in events:
        validate_event(rec)
    kinds = [rec["event"] for rec in events]
    payload = read_heartbeat(beat)
    shutil.rmtree(tmp, ignore_errors=True)
    if kinds.count("serve_tick") != ticks or kinds.count("serve_drain") != 1 or \
            kinds.count("serve_request") != len(finished):
        raise AssertionError(f"(d) events: {kinds.count('serve_tick')} serve_tick for {ticks} ticks, "
                             f"{kinds.count('serve_drain')} serve_drain, {kinds.count('serve_request')} "
                             f"serve_request for {len(finished)} finished")
    if not payload or payload.get("role") != "serving" or payload.get("pid") != os.getpid():
        raise AssertionError(f"(d) heartbeat payload {payload}")
    drain.update(in_flight_at_signal=len(at_signal["in_flight"]), refused=len(refused),
                 finished=len(finished))
    out["c_drain"] = drain
    out["d_telemetry"] = dict(events={k: kinds.count(k) for k in sorted(set(kinds))}, ticks=ticks,
                              heartbeat=payload)
    log(f"phase 14 (c) drain: rc 143, {len(finished)} in flight finished in full, {len(refused)} queued "
        f"refused, pool free; (d) {len(events)} serve events valid ({out['d_telemetry']['events']}), "
        f"heartbeat role {payload['role']} tick {payload['tick']}  [{card}]")
    return out, total


# ---------------------------------------------------------------------------
# phase 15: the training engine's resilience
# ---------------------------------------------------------------------------
#: the model of phase 15: phase 10's, on the flash kernels (dropout 0)
RES_MODEL = dict(attention_backend="flash")
#: steps of the uninterrupted reference run (and of (b)), and of (c)
RES_STEPS = 6
RES_AGENT_STEPS = 4
#: the fault of (c)'s first launch, and the guard of (e)
RES_AGENT_FAULT = "step=sigkill@3"
RES_GUARD = 3


def res_config(**over) -> dict:
    """Phase 10's engine config with a heartbeat every step (so that a
    supervisor reads each step's count), ``over``'s blocks on top."""
    cfg = api_config()
    cfg["resilience"] = dict(cfg["resilience"], heartbeat_interval=0, **over.pop("resilience", {}))
    cfg.update(over)
    return cfg


def res_batches(seed: int) -> list:
    """The seeded global batches of phase 15, one a step (the children
    make the same ones from the same seed)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, API_MODEL["vocab_size"], (16, API_MODEL["n_positions"])).astype(np.int32)
            for _ in range(RES_STEPS + 2)]


def _param_sha(engine) -> str:
    """A sha256 over the sha256 of every parameter (hashed on threads)."""
    from deepspeed_tpu_torch.runtime.resilience.manifest import state_leaf_entries
    return hashlib.sha256(json.dumps(state_leaf_entries(dict(engine.module.named_parameters())),
                                     sort_keys=True).encode()).hexdigest()


def _spans(targets):
    """Wrap each ``(label, module, name)`` of ``targets`` so that its calls,
    from any thread, record ``(label, start, end)`` on the perf counter.
    Returns the span list and a function that restores the originals."""
    spans, saved = [], []
    for label, mod, name in targets:
        fn = getattr(mod, name)

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                spans.append((_label, t0, time.perf_counter()))

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return spans, restore


def _child_cmd(role: str, seed: int, where: str, out: str, steps: int) -> list:
    return [sys.executable, os.path.abspath(__file__), "--child", role, "--seed", str(seed),
            "--dir", where, "--out", out, "--steps", str(steps)]


def _records(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _child_log_tail(out: str) -> str:
    try:
        with open(out + ".log") as f:
            return f.read()[-3000:]
    except OSError:
        return "(no log)"


def child_main(args) -> int:
    """A training process of phase 15 (``--child ROLE``): ``preempt``
    trains with ``preempt_save_dir`` armed until a signal ends it;
    ``resume`` calls ``resume()`` with no dir and trains on; ``agent`` runs
    under ``DSElasticAgent`` (``resume(dir)``, an async save after each odd
    step, flushed after the next; the first launch carries
    ``RES_AGENT_FAULT``); ``torn`` saves twice, the second time with
    ``ckpt_pre_rename=sigkill``. Records go to ``--out`` as JSON lines, the
    output to ``--out``.log. It runs on CUDA and raises without it, and
    never prints the contract line."""
    fd = os.open(args.out + ".log", os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    marks = {"module": MODULE_T0}

    def record(**row):
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")

    if not torch.cuda.is_available():
        raise RuntimeError("a phase 15 child runs on CUDA, and torch.cuda.is_available() is false")
    import deepspeed_tpu_torch  # noqa: F401
    from deepspeed_tpu_torch.ops.cuda import build
    from deepspeed_tpu_torch.runtime.resilience import faults
    marks["imports"] = time.time()
    restart = int(os.environ.get("DS_ELASTIC_RESTART_COUNT", "0"))
    if args.child == "agent" and restart == 0:
        os.environ[faults.FAULT_ENV] = RES_AGENT_FAULT
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    marks["cuda_context"] = time.time()
    over = {}
    if args.child in ("preempt", "resume"):
        over["resilience"] = {"preempt_save_dir": args.dir}
    if args.child == "agent":
        over["nebula"] = {"enabled": True}
    engine = _api_engine(args.seed, config=res_config(**over), **RES_MODEL)
    torch.cuda.synchronize()
    marks["model"] = time.time()
    for name in TRAINING_KERNELS:
        build.load(name)
    marks["kernels"] = time.time()
    tag = None
    if args.child == "resume":
        tag = engine.resume()  # the armed preempt_save_dir
    elif args.child == "agent":
        tag = engine.resume(args.dir)
    torch.cuda.synchronize()
    marks["load"] = time.time()
    record(role=args.child, restart=restart, start_step=engine.global_steps, tag=tag, marks=marks)
    batches = res_batches(args.seed)
    while engine.global_steps < args.steps:
        loss = float(engine.train_batch(batches[engine.global_steps]))
        record(step=engine.global_steps, loss=loss, t=time.time())
        if args.child == "agent":
            if engine.global_steps % 2 == 1:
                engine.save_checkpoint(args.dir)
            else:
                engine.flush_checkpoints()
        elif args.child == "torn":
            if engine.global_steps == 2:
                os.environ[faults.FAULT_ENV] = "ckpt_pre_rename=sigkill"
            engine.save_checkpoint(args.dir, tag=f"step{engine.global_steps}")
    engine.flush_checkpoints()
    record(done=True, steps=engine.global_steps, sha=_param_sha(engine))
    return 0


def _restart_parts(rec: dict, started: float, first_step_t: float) -> dict:
    """A relaunch's seconds by part, from the supervisor's restart call to
    the child's first step."""
    m = rec["marks"]
    return {"process start (to the script's first line)": m["module"] - started,
            "imports (torch, the port)": m["imports"] - m["module"],
            "CUDA context": m["cuda_context"] - m["imports"],
            "model and engine build (350m, seeded init)": m["model"] - m["cuda_context"],
            "kernel libraries loaded": m["kernels"] - m["model"],
            "verified load (resume)": m["load"] - m["kernels"],
            "first step": first_step_t - m["load"],
            "total": first_step_t - started}


def _check(name: str, ok: bool, detail) -> None:
    if not ok:
        raise AssertionError(f"resilience {name}: {detail}")
    RESULTS["checks"].append({"name": f"resilience {name}", "ok": True})


def resilience_phase(seed: int, card: str):
    """Phase 15 (module docstring). Returns its results and the launch
    counts of its main path: the uninterrupted reference run in this
    process, zeroed just before it and read just after."""
    from deepspeed_tpu_torch.elasticity import DSElasticAgent, read_heartbeat
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches
    from deepspeed_tpu_torch.runtime.fp16.loss_scaler import OverflowAbort
    from deepspeed_tpu_torch.runtime.resilience import faults, manifest

    seed = seed + 15
    batches = res_batches(seed)
    work = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    out, part_s, procs = {}, {}, []
    env = {k: v for k, v in os.environ.items() if k != faults.FAULT_ENV}

    def latest(where):
        try:
            with open(os.path.join(where, "latest")) as f:
                return f.read().strip()
        except OSError:
            return None

    try:
        # ---- the main path: the uninterrupted run, counts zeroed just before ----
        t_part = time.perf_counter()
        ref = _api_engine(seed, config=res_config(), **RES_MODEL)
        a_dir = os.path.join(work, "a")
        reset_launches()
        ref_losses, shas, sync_save = [], {}, None
        for i in range(RES_STEPS):
            ref_losses.append(float(ref.train_batch(batches[i])))
            if i + 1 == 2:
                sync_save = _profiled(lambda: ref.save_checkpoint(a_dir, tag="sync"), SAVE_PARTS)
            if i + 1 in (RES_AGENT_STEPS, RES_STEPS):
                shas[i + 1] = _param_sha(ref)
        counts = launches()
        # ---- end of the main path ----
        per_step = {k: c / RES_STEPS for k, c in counts.items()}
        layers = ref.module.config.n_layer * API_GAS  # a layer of each micro-batch
        _check("reference run launches K1 and K4 (forward and remat recompute; backward)",
               per_step["flash_fwd"] == 2 * layers and per_step["flash_bwd"] == layers, per_step)
        _check("reference losses finite", all(np.isfinite(ref_losses)), ref_losses)

        # (a) async saves
        neb = _api_engine(seed, config=res_config(nebula={"enabled": True}), **RES_MODEL)
        losses, step_ms = [], {"no save pending": [], "save pending": []}

        def step(i, kind):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(neb.train_batch(batches[i])))
            if kind:
                step_ms[kind].append((time.perf_counter() - t0) * 1e3)

        step(0, None)  # warm-up
        step(1, "no save pending")
        # the writer's parts, timed where it looks them up, beside the steps
        spans, restore = _spans((("leaf digests", manifest, "state_leaf_entries"),
                                 ("torch.save", torch, "save"),
                                 ("file digests", manifest, "file_inventory"),
                                 ("fsync", manifest, "fsync_tree")))
        t_save = time.perf_counter()
        neb.save_checkpoint(a_dir, tag="async")
        block_s = time.perf_counter() - t_save
        hidden = "async" not in manifest.list_checkpoint_tags(a_dir)
        marker = latest(a_dir)
        _check("(a) async save returns before its tag is published", hidden and marker == "sync",
               f"listed {manifest.list_checkpoint_tags(a_dir)}, latest {marker}")
        pending_steps = []
        for i in (2, 3, 4):
            t0 = time.perf_counter()
            step(i, "save pending")
            pending_steps.append(("step", t0 - t_save, time.perf_counter() - t_save))
        t0 = time.perf_counter()
        neb.flush_checkpoints()
        flush_s = time.perf_counter() - t0
        restore()
        timeline = pending_steps + [("flush", t0 - t_save, t0 - t_save + flush_s)] + sorted(
            (label, a - t_save, b - t_save) for label, a, b in spans)
        for i in (5, 6, 7):
            step(i, "no save pending")
        _check("(a) flush publishes the tag and latest", latest(a_dir) == "async"
               and "async" in manifest.list_checkpoint_tags(a_dir), manifest.list_checkpoint_tags(a_dir))
        leaves = {t: manifest.read_manifest(os.path.join(a_dir, t))["leaves"] for t in ("sync", "async")}
        _check("(a) async tag's leaf digests == the synchronous save's", leaves["sync"] == leaves["async"],
               [k for k in leaves["sync"] if leaves["sync"][k] != leaves["async"].get(k)][:4])
        _check("(a) the async engine's losses == the reference's", losses[:RES_STEPS] == ref_losses,
               (losses, ref_losses))
        del neb
        torch.cuda.empty_cache()
        # the async tag, loaded with verify "full" into the reference
        # engine, trains steps 3-6 to the reference's bits
        verified = _profiled(lambda: ref.load_checkpoint(a_dir, tag="async"), LOAD_PARTS)
        again = [float(ref.train_batch(batches[i])) for i in range(2, RES_STEPS)]
        _check("(a) the async tag loads verified and trains steps 3-6 bit-equal",
               again == ref_losses[2:] and _param_sha(ref) == shas[RES_STEPS], (again, ref_losses[2:]))
        out["a_async"] = {"sync_save": sync_save, "async_save_blocking_s": block_s,
                          "flush_wait_s": flush_s, "step_ms": step_ms, "writer_timeline_s": timeline,
                          "step_ms_summary": {k: _ms_summary(v) for k, v in step_ms.items()},
                          "verified_load": verified, "gb": _dir_bytes(os.path.join(a_dir, "async")) / 1e9}
        shutil.rmtree(a_dir)
        part_s["a"] = time.perf_counter() - t_part

        # (b) preemption: SIGTERM after the heartbeat shows step 2
        t_part = time.perf_counter()
        b_dir, hb = os.path.join(work, "b"), os.path.join(work, "b.heartbeat")
        rec_p, rec_r = os.path.join(work, "b_preempt.jsonl"), os.path.join(work, "b_resume.jsonl")
        proc = subprocess.Popen(_child_cmd("preempt", seed, b_dir, rec_p, RES_STEPS),
                                env=dict(env, DS_ELASTIC_HEARTBEAT_FILE=hb))
        procs.append(proc)
        deadline = time.time() + 600
        while proc.poll() is None and time.time() < deadline:
            beat = read_heartbeat(hb)
            if beat and beat.get("global_step", 0) >= 2:
                break
            time.sleep(0.05)
        if proc.poll() is not None:
            raise AssertionError(f"resilience (b): the preempted child exited {proc.returncode} before "
                                 f"step 2: {_child_log_tail(rec_p)}")
        signalled_at_step = read_heartbeat(hb)["global_step"]
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=600)
        sig_to_exit_s = time.perf_counter() - t_sig
        tags = manifest.list_checkpoint_tags(b_dir)
        _check("(b) SIGTERM: checkpoint at the next boundary, exit 143",
               rc == 143 and len(tags) == 1 and latest(b_dir) == tags[0],
               f"rc {rc}, tags {tags}: {_child_log_tail(rec_p)}")
        # (d)'s child runs beside the resumed one: neither is timed
        d_dir, rec_d = os.path.join(work, "d"), os.path.join(work, "d.jsonl")
        torn = subprocess.Popen(_child_cmd("torn", seed, d_dir, rec_d, 2), env=env)
        procs.append(torn)
        rc2 = subprocess.run(_child_cmd("resume", seed, b_dir, rec_r, RES_STEPS), env=env,
                             timeout=900).returncode
        pre, post = _records(rec_p), _records(rec_r)
        _check("(b) the resumed child runs", rc2 == 0 and post and post[-1].get("done"),
               f"rc {rc2}: {_child_log_tail(rec_r)}")
        saved_at = post[0]["start_step"]
        got = {r["step"]: r["loss"] for r in pre + post if "loss" in r}
        _check("(b) resume() from the armed dir: losses and parameters bit-equal",
               post[0]["tag"] == [tags[0], {}] and all(got[s] == ref_losses[s - 1] for s in got)
               and set(got) == set(range(1, RES_STEPS + 1)) - {saved_at}
               and post[-1]["sha"] == shas[RES_STEPS], (got, ref_losses, post[0]))
        out["b_preempt"] = {"signalled_at_step": signalled_at_step, "saved_at_step": saved_at,
                            "signal_to_exit_s": sig_to_exit_s, "rc": rc}
        shutil.rmtree(b_dir)
        part_s["b"] = time.perf_counter() - t_part

        # (d) a torn save: SIGKILL between staging and publish
        t_part = time.perf_counter()
        rc = torn.wait(timeout=900)
        tags = manifest.list_checkpoint_tags(d_dir)
        _check("(d) the torn save is invisible",
               rc == -9 and tags == ["step1"] and latest(d_dir) == "step1"
               and os.path.isdir(os.path.join(d_dir, ".tmp.step2")),
               f"rc {rc}, tags {tags}, dir {os.listdir(d_dir)}: {_child_log_tail(rec_d)}")
        t0 = time.perf_counter()
        resumed = ref.resume(d_dir)
        resume_s = time.perf_counter() - t0
        loss2 = float(ref.train_batch(batches[1]))
        _check("(d) resume() restores the first tag and sweeps the torn one",
               resumed == ("step1", {}) and not os.path.exists(os.path.join(d_dir, ".tmp.step2"))
               and loss2 == ref_losses[1], (resumed, loss2, ref_losses[1]))
        out["d_torn"] = {"rc": rc, "resume_s": resume_s}
        shutil.rmtree(d_dir)
        del ref
        torch.cuda.empty_cache()
        part_s["d"] = time.perf_counter() - t_part

        # (c) the agent: SIGKILL at step 3 of the first launch
        t_part = time.perf_counter()
        c_dir, rec_c = os.path.join(work, "c"), os.path.join(work, "c.jsonl")
        restarted = []
        agent = DSElasticAgent(_child_cmd("agent", seed, c_dir, rec_c, RES_AGENT_STEPS), world_sizes=[1],
                               heartbeat_timeout=300, startup_timeout=900, max_restarts=2,
                               poll_interval=0.2, checkpoint_dir=c_dir,
                               env={faults.FAULT_ENV: ""},
                               on_restart=lambda n, w: restarted.append(time.time()))
        rc = agent.run(workdir=work)
        hist = agent.history
        _check("(c) the agent returns 0 after one SIGKILL restart",
               rc == 0 and [h["rc"] for h in hist] == [-9, 0] and len(restarted) == 1,
               f"rc {rc}, history {hist}: {_child_log_tail(rec_c)}")
        _check("(c) history rows: step 3's heartbeat, then a plain resume",
               hist[0]["last_heartbeat"]["global_step"] == 3 and hist[0]["topology"]["resume"] == "fresh"
               and hist[1]["topology"]["resume"] == "plain" and hist[1]["topology"]["tag"] == "global_step1",
               hist)
        rows = _records(rec_c)
        starts = [i for i, r in enumerate(rows) if "marks" in r]
        first, second = rows[starts[0]:starts[1]], rows[starts[1]:]
        got = [(r["step"], r["loss"]) for r in first + second if "loss" in r]
        want = [(s, ref_losses[s - 1]) for s in (1, 2)] + [(s, ref_losses[s - 1])
                                                            for s in range(2, RES_AGENT_STEPS + 1)]
        _check("(c) the restarted run is bit-equal to the uninterrupted one",
               got == want and second[-1].get("sha") == shas[RES_AGENT_STEPS], (got, want))
        out["c_agent"] = {"history": hist,
                          "restart_parts_s": _restart_parts(second[0], restarted[0], second[1]["t"]),
                          "first_launch_parts_s": {k: v for k, v in _restart_parts(
                              first[0], first[0]["marks"]["module"], first[1]["t"]).items()
                              if not k.startswith("process start")}}
        shutil.rmtree(c_dir)
        part_s["c"] = time.perf_counter() - t_part

        # (e) the overflow guard on poisoned batches
        t_part = time.perf_counter()
        eng = _api_engine(seed, config=res_config(resilience={"max_consecutive_overflows": RES_GUARD}),
                          loss_fn=faults.overflow_injected_loss(), **RES_MODEL)
        healthy = float(eng.train_batch(batches[0]))
        before = _params(eng)
        poisoned = faults.poison_batch({"input_ids": batches[1]})
        aborted_at = None
        for n in range(1, RES_GUARD + 3):
            try:
                eng.train_batch(poisoned)
            except OverflowAbort as e:
                aborted_at, message = n, str(e)
                break
        _check("(e) OverflowAbort at the third skipped step, parameters unchanged",
               aborted_at == RES_GUARD and eng.skipped_steps == RES_GUARD
               and _same_bits(before, _params(eng)) and np.isfinite(healthy),
               (aborted_at, eng.skipped_steps))
        out["e_overflow"] = {"aborted_at_poisoned_step": aborted_at, "message": message[:200]}
        del eng, before
        torch.cuda.empty_cache()
        part_s["e"] = time.perf_counter() - t_part
    finally:
        for proc in procs:  # a child still running when a check failed
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    out["part_s"] = part_s
    a = out["a_async"]
    sm = a["step_ms_summary"]
    log(f"resilience (a): sync save {a['sync_save']['s']:.2f} s "
        f"({', '.join(f'{k} {v:.2f}' for k, v in a['sync_save']['by_part_s'].items())}); async save "
        f"blocks {a['async_save_blocking_s']:.3f} s, the flush waits {a['flush_wait_s']:.2f} s; step ms "
        f"with a save pending {a['step_ms']['save pending']} against "
        f"{a['step_ms']['no save pending']} without; {a['gb']:.3f} GB; verified load "
        f"{a['verified_load']['s']:.2f} s  [{card}]")
    log("resilience (a): from the async save's call (s): " + ", ".join(
        f"{label} {t0:.2f}-{t1:.2f}" for label, t0, t1 in a["writer_timeline_s"]))
    log(f"resilience (b): SIGTERM at step {out['b_preempt']['signalled_at_step']}, saved at step "
        f"{out['b_preempt']['saved_at_step']}, exit 143 {out['b_preempt']['signal_to_exit_s']:.2f} s "
        f"after the signal; the resumed child bit-equal  [{card}]")
    log(f"resilience (c): agent rc 0, history rc {[h['rc'] for h in out['c_agent']['history']]}; "
        f"restart by part (s): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                             out['c_agent']['restart_parts_s'].items()) + f"  [{card}]")
    log(f"resilience (d): torn save rc -9, invisible; resume {out['d_torn']['resume_s']:.2f} s  [{card}]")
    log(f"resilience (e): OverflowAbort at poisoned step {out['e_overflow']['aborted_at_poisoned_step']}"
        f"  [{card}]")
    log("resilience seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()))
    return out, counts


# ---------------------------------------------------------------------------
# phase 16: MoE serving and Mixtral
# ---------------------------------------------------------------------------
#: phase 16 (a)'s model: phase 7's MoE layout on phase 4's serving model
MOE_SERVE_MODEL = dict(moe_num_experts=8, moe_layer_freq=2, moe_k=1)
#: Mixtral-8x7B's depth in phase 16 (b) (serving) and (c) (training). At 2
#: layers (3.16 B parameters, 50.6 GB of fp32 masters, gradients and Adam
#: moments) the step ran out of the card's 79 GiB in ``FusedAdam.step``,
#: whose ``torch._foreach_*`` temporaries take about three times the fp32
#: parameter bytes; 1 layer (1.71 B parameters) fits
MIXTRAL_SERVE_LAYERS = 8
MIXTRAL_TRAIN_LAYERS = 1


def _gate_maps(gen, tokens: int, experts: int, k: int, capacity_factor: float):
    """The sorted route's maps from the gate's own decisions on random
    logits (eval gating: no noise): ``flat_slot`` [1, tokens * k] with
    dropped copies on the E*C sentinel, its inverse ``src`` [1, E*C], and
    the capacity C."""
    from deepspeed_tpu_torch.moe import sharded_moe as sm
    from deepspeed_tpu_torch.ops.cuda.moe_dispatch import inverse_index
    logits = torch.randn(tokens, experts, generator=gen, device="cuda")
    capacity = sm._gate_capacity(tokens, experts, capacity_factor, 4, True, k)
    if k == 1:
        _, routing, _ = sm.top1routing(logits, capacity_factor, 4, use_rts=False)
    else:
        _, routing, _ = sm.top2routing(logits, capacity_factor, 4)
    flat = torch.where(routing.keep > 0, routing.expert * capacity + routing.slot,
                       experts * capacity).to(torch.int32).reshape(1, tokens * k)
    return flat, inverse_index(flat, experts * capacity), capacity


def k5_routed_times(gen) -> dict:
    """K5 where phase 16 runs it, on the gate's own maps: the GPT-2 350m MoE
    decode tick's dispatch and combine (8 tokens, 8 experts, top-1, eval
    factor 2.0: C = 4, M = 1024) and Mixtral training's (4096 tokens, top-2,
    factor 1.25: [1, 8192, 4096] -> [1, 10240, 4096] and back), bf16: each
    against its plain version (exact, forward and VJP), then K5, the plain
    gather and ``index_select`` timed as phase 3 times them (three rotating
    input copies; K5 and ``index_select`` device-side), and the bound."""
    from deepspeed_tpu_torch.ops.cuda import moe_dispatch as md

    out = {}
    for label, tokens, experts, k, cf, m in (("gpt2_350m_moe_decode_tick", 8, 8, 1, 2.0, 1024),
                                             ("mixtral_train_step", 4096, 8, 2, 1.25, 4096)):
        flat, src, cap = _gate_maps(gen, tokens, experts, k, cf)
        for what, n_rows, fwd, bwd in (("dispatch", tokens * k, src, flat),
                                       ("combine", experts * cap, flat, src)):
            x = torch.randn(1, n_rows, m, generator=gen, device="cuda").to(torch.bfloat16)
            cot = torch.randn(1, fwd.shape[1], m, generator=gen, device="cuda").to(torch.bfloat16)
            xk = x.detach().requires_grad_()
            got = md.permute_rows(xk, fwd, bwd, impl="pallas")
            (gk,) = torch.autograd.grad(got, xk, cot)
            xp = x.detach().requires_grad_()
            ref = md.permute_rows(xp, fwd, bwd, impl="xla")
            (gp,) = torch.autograd.grad(ref, xp, cot)
            name = f"moe_permute {label} {what} [1,{n_rows},{m}]->[1,{fwd.shape[1]},{m}] bf16"
            err = max(compare_exact(name, got.detach(), ref.detach()),
                      compare_exact(f"{name} VJP", gk, gp))
            del x, cot, xk, xp
            t = k5_times(lambda: torch.randn(1, n_rows, m, generator=gen, device="cuda").to(torch.bfloat16),
                         fwd, n_rows, m)
            shape = (f"x [1,{n_rows},{m}] bf16 -> [1,{fwd.shape[1]},{m}], {t.pop('live')} live rows "
                     f"({what}, {tokens} tokens, E={experts} k={k} C={cap})")
            out[f"{label} {what}"] = dict(shape=shape, max_abs_err=err, **t)
            log_k5_time(f"{label} {shape}", t)
    RESULTS["timings"]["moe_permute_phase16"] = out
    return out


def _moe_layers(module) -> list:
    from deepspeed_tpu_torch.moe import MOELayer
    return [m for m in module.modules() if isinstance(m, MOELayer)]


def _moe_tick_probe(sched):
    """Wrap the scheduler's prefill and decode steps: each call's launch
    counts (read around it, as :func:`_read_launches`), and its MoE layers'
    keep flags [layers, rows] beside the rows of occupied slots (a slot
    whose write position is not the parked sentinel; in a prefill tick its
    chunk's real rows), so the tokens dropped by capacity are counted per
    tick after the run without a host sync inside it. Returns the record
    and a function that takes the wrappers off again."""
    from deepspeed_tpu_torch.ops.cuda import LAUNCHES, launches, reset_launches
    layers = _moe_layers(sched.module)
    probe = {"prefill": [], "decode": []}

    def wrap(kind, fn):
        def run(cache, ids, *rest):
            pos = next(v for k, v in cache.items() if k.endswith("position_index")).clone()
            before = launches()
            reset_launches()
            try:
                return fn(cache, ids, *rest)
            finally:
                got = launches()
                for name, n in before.items():
                    LAUNCHES[name] = n + got[name]
                last = rest[0] if kind == "prefill" else None
                keep = torch.stack([layer.last_routing.keep.reshape(-1) for layer in layers])
                probe[kind].append(dict(launches=got, pos=pos, last=last, keep=keep,
                                        width=ids.shape[1] if ids.dim() > 1 else 1))

        return run

    fns = sched.fns
    sched.fns = dict(fns, prefill=wrap("prefill", fns["prefill"]), decode=wrap("decode", fns["decode"]))

    def restore():
        sched.fns = fns

    return probe, restore


def _moe_tick_summary(probe: dict, capacity: int, want: dict) -> dict:
    """Per tick kind: the distinct launch counts of its calls (each must be
    ``want``), and the rows dropped by capacity: all rows, and the rows of
    occupied slots (mean and max a tick over the MoE layers summed)."""
    out = {}
    for kind, calls in probe.items():
        if not calls:
            continue
        seen = {name: sorted({c["launches"][name] for c in calls}) for name in want}
        if any(v != [want[name]] for name, v in seen.items()):
            raise AssertionError(f"phase 16 (a) {kind} tick launches {seen}, expected {want} a tick")
        dropped, dropped_live = [], []
        for c in calls:
            keep = c["keep"].cpu()  # [layers, slots * width]
            rows = keep.reshape(keep.shape[0], -1, c["width"])
            live = (c["pos"] < capacity)[:, None].expand(-1, c["width"]).clone()
            if c["last"] is not None:
                live &= torch.arange(c["width"])[None, :] <= c["last"].cpu()[:, None]
            dropped.append(int((rows == 0).sum()))
            dropped_live.append(int(((rows == 0) & live[None]).sum()))
        out[kind] = dict(ticks=len(calls), launches_per_tick={n: v[0] for n, v in seen.items()},
                         dropped_rows_per_tick_mean=float(np.mean(dropped)),
                         dropped_rows_per_tick_max=max(dropped),
                         dropped_occupied_rows_per_tick_mean=float(np.mean(dropped_live)),
                         dropped_occupied_rows_per_tick_max=max(dropped_live),
                         dropped_occupied_rows_total=sum(dropped_live))
    return out


def _used_routing(module) -> dict:
    """The routing each MoE layer of ``module`` last ran under (injected or
    its own), keyed by its gate's name as ``injected_routing`` keys it."""
    from deepspeed_tpu_torch.moe import MOELayer
    return {f"{name}.gate": type(m.last_routing)(*(t[0].cpu() for t in m.last_routing))
            for name, m in module.named_modules() if isinstance(m, MOELayer)}


def _same_routing(a: dict, b: dict) -> int:
    """Token copies whose expert, slot or keep differ between two routings
    of the same gates."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"routing of other gates: {sorted(a)} vs {sorted(b)}")
    return sum(int(((a[n].expert != b[n].expert) | (a[n].slot != b[n].slot)
                    | (a[n].keep != b[n].keep)).sum()) for n in a)


def _held_logits(label: str, runs: dict, out: dict) -> None:
    """Phase 4 (c)'s rule on ``runs`` {name: {tick: logits}}: fp32 card
    against plain within 1e-4; bf16 card against plain bf16 within 1.5x the
    rounding of plain bf16 against plain fp32, that yardstick run under the
    plain bf16 run's routing (``plain_fp32_bf16_routing``)."""
    for tick in ("prefill", "decode"):
        compare(f"{label} {tick} logits fp32 (card vs plain)", runs["served_fp32"][tick],
                runs["plain_fp32"][tick], torch.float32)
        rounding = rel_err(runs["plain_bf16"][tick], runs["plain_fp32_bf16_routing"][tick])[1]
        out[f"{tick}_bf16_rounding_rel"] = rounding
        compare(f"{label} {tick} logits bf16 (card vs plain, plain bf16 routing, 1.5x rounding)",
                runs["served_bf16"][tick], runs["plain_bf16"][tick], torch.bfloat16,
                tol=1.5 * rounding)


def _routed_runs(label: str, order, run_one) -> dict:
    """The sides of a card-against-CPU check of an MoE model, each
    ``run_one(name, device, dtype, routing) -> ({tick: logits}, {tick:
    {gate: the routing it ran under}})``: plain bf16 first, the card's bf16
    under its routing, both fp32 sides free (their routings must agree),
    and plain fp32 once more under the bf16 routing (the yardstick)."""
    runs, used = {}, {}
    for name, device, dtype in order:
        inject = used.get("plain_bf16") if name in ("served_bf16", "plain_fp32_bf16_routing") else None
        runs[name], used[name] = run_one(name, device, dtype, inject)
    flips = sum(_same_routing(used["served_fp32"][t], used["plain_fp32"][t]) for t in used["plain_fp32"])
    if flips:
        raise AssertionError(f"{label} fp32: the card and the plain run route {flips} token copies apart")
    RESULTS["checks"].append({"name": f"{label} fp32 routing identical", "ok": True})
    for name in ("served_bf16", "plain_fp32_bf16_routing"):
        for t in used[name]:
            if _same_routing(used[name][t], used["plain_bf16"][t]):
                raise AssertionError(f"{label}: {name} did not follow the injected routing ({t})")
    return runs


SIDES = (("plain_bf16", "cpu", torch.bfloat16), ("served_bf16", "cuda", torch.bfloat16),
         ("served_fp32", "cuda", torch.float32), ("plain_fp32", "cpu", torch.float32),
         ("plain_fp32_bf16_routing", "cpu", torch.float32))


def moe_scheduler_phase(seed: int, card: str):
    """Phase 16 (a): GPT-2 350m with 8 experts in every other block (top-1,
    eval factor 2.0), bf16, through ``init_inference(kernel_inject=True,
    use_flash_prefill=True)`` and ``ContinuousBatchingScheduler`` at the JAX
    defaults with int8 weights (experts and gate bf16), int8 KV and the
    prefix cache on, serving phase 4 (b)'s 16 requests; launches per tick
    asserted, tokens dropped by capacity a tick, ten profiled decode ticks;
    the first prefill and decode ticks at 2 layers, card against CPU; and
    at 2 layers in fp32, lockstep ``generate`` against the scheduler."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
    from deepspeed_tpu_torch.inference.serving import (FINISHED, ContinuousBatchingScheduler, Request,
                                                       ServingConfig)
    from deepspeed_tpu_torch.inference.serving.programs import (make_apply_fn, make_slot_cache,
                                                                stamp_lengths)
    from deepspeed_tpu_torch.testing import injected_routing

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    cfg = get_gpt2_config("350m", dtype=torch.bfloat16, param_dtype=torch.bfloat16, **MOE_SERVE_MODEL)
    engine = init_inference(GPT2LMHeadModel(cfg, device="cuda", generator=gen), dtype="bf16",
                            kernel_inject=True, use_flash_prefill=True)
    moe_layers = [i for i in range(cfg.n_layer) if cfg.is_moe_layer(i)]
    dense = cfg.n_layer - len(moe_layers)
    want = {"quant_matmul": 2 * cfg.n_layer + 2 * dense, "flash_decode": cfg.n_layer,
            "moe_permute": 2 * len(moe_layers)}
    if want != {"quant_matmul": 72, "flash_decode": 24, "moe_permute": 24}:
        raise AssertionError(f"phase 16 (a): the 350m MoE model's launches a tick reckon to {want}")
    scfg = ServingConfig(slots=8, weight_dtype="int8")
    rng = np.random.default_rng(seed)
    prompts = serving_trace(rng, cfg.vocab_size)
    trace = [(p, 32) for p in prompts]
    holder = {}

    def install(sched):
        holder["probe"], holder["restore"] = _moe_tick_probe(sched)

    t_part = time.perf_counter()
    seconds = {}
    sched, reqs, run = _serve_run("16 (a) MoE GPT-2 350m", engine, scfg, trace, card, prepare=install)
    holder["restore"]()
    if not all(r.state == FINISHED and len(r.output) == 32 for r in reqs):
        raise AssertionError("phase 16 (a): not every request finished with 32 tokens")
    missing = [k for k in ("quant_matmul", "flash_decode", "moe_permute") if run["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"phase 16 (a): kernels never launched: {missing} ({run['launches']})")
    ticks = _moe_tick_summary(holder["probe"], sched.capacity, want)
    out.update(run=run, ticks=ticks, capacity_decode=sched.module.blocks[1].moe.deepspeed_moe.gate.capacity(8))
    log(f"phase 16 (a) launches a tick {ticks['decode']['launches_per_tick']} (decode), "
        f"{ticks['prefill']['launches_per_tick']} (prefill); rows dropped by capacity a tick: decode "
        f"mean {ticks['decode']['dropped_rows_per_tick_mean']:.2f} max {ticks['decode']['dropped_rows_per_tick_max']}"
        f" (occupied slots' rows: mean {ticks['decode']['dropped_occupied_rows_per_tick_mean']:.2f}, total "
        f"{ticks['decode']['dropped_occupied_rows_total']}), prefill mean "
        f"{ticks['prefill']['dropped_rows_per_tick_mean']:.2f} (occupied "
        f"{ticks['prefill']['dropped_occupied_rows_total']} in all)  [{card}]")
    pool_shape = (sched.slots, sched.capacity, cfg.n_head, cfg.head_dim)
    out["profile"] = _profile_decode_ticks(sched, prompts[:8], card, pool_shape)
    del sched, engine
    torch.cuda.empty_cache()
    seconds["build, serve, profile"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # ---- the first prefill and decode ticks at 2 layers, card against CPU ----
    small = get_gpt2_config("350m", n_layer=2, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                            **MOE_SERVE_MODEL)
    base = init_inference(GPT2LMHeadModel(small, device="cuda",
                                          generator=torch.Generator(device="cuda").manual_seed(seed + 6)),
                          dtype="bf16", kernel_inject=True, use_flash_prefill=True)
    served = ContinuousBatchingScheduler(base, ServingConfig(slots=8, weight_dtype="int8")).module
    ids = torch.as_tensor(np.stack([p[:16] for p in prompts[:8]]).astype(np.int64))
    nxt = {}

    def run_one(name, device, dtype, inject):
        module = served if name == "served_bf16" else _copy_module(served, torch.device(device), dtype)
        apply_fn = make_apply_fn(module)
        cache = make_slot_cache(module, 8, kv_quant=dtype == torch.bfloat16)
        zeros = np.zeros(8, np.int64)
        logits, used = {}, {}
        for tick, feed, at in (("prefill", lambda: ids, zeros), ("decode", lambda: nxt["tok"][:, None], zeros + 16)):
            with injected_routing(None if inject is None else inject[tick], model=module):
                logits[tick] = apply_fn(stamp_lengths(cache, at), feed().to(device))[:, -1].float().cpu()
            used[tick] = _used_routing(module)
            if name == "plain_bf16" and tick == "prefill":
                nxt["tok"] = logits[tick].argmax(-1)
        del module, cache
        return logits, used

    runs = _routed_runs("phase 16 (a) 2-layer ticks", SIDES, run_one)
    _held_logits("phase 16 (a) 2-layer", runs, out)
    del served, base
    torch.cuda.empty_cache()
    seconds["2-layer ticks card vs CPU"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # ---- lockstep generate against the scheduler, fp32, 2 layers ----
    fp32 = init_inference(GPT2LMHeadModel(dataclasses.replace(small, dtype=torch.float32,
                                                              param_dtype=torch.float32), device="cuda",
                                          generator=torch.Generator(device="cuda").manual_seed(seed + 7)),
                          dtype="fp32", kernel_inject=True, use_flash_prefill=True)
    short = [p[:12] for p in prompts[:4]]  # under one chunk: no prefill call of either path drops a token
    lockstep = [fp32.generate(p[None], max_new_tokens=8)[0, 12:].tolist() for p in short]
    sched = ContinuousBatchingScheduler(fp32, ServingConfig(slots=8, weight_dtype="fp", kv_quant=False))
    served_tokens = []
    for p in short:
        r = sched.submit(Request(p, max_new_tokens=8))
        sched.run_until_drained()
        served_tokens.append(list(r.output))
    same = served_tokens == lockstep
    RESULTS["checks"].append({"name": "phase 16 (a) fp32 lockstep generate vs scheduler tokens",
                              "ok": same})
    log(f"check phase 16 (a) fp32 2-layer lockstep generate vs the scheduler (one request at a time, "
        f"fp KV): {'token-identical' if same else 'FAIL'} ({lockstep} vs {served_tokens})  [{card}]")
    if not same:
        raise AssertionError(f"phase 16 (a): lockstep {lockstep} vs scheduler {served_tokens}")
    out["lockstep_vs_scheduler_fp32"] = dict(lockstep=lockstep, scheduler=served_tokens)
    del sched, fp32
    torch.cuda.empty_cache()
    seconds["lockstep vs scheduler"] = time.perf_counter() - t_part
    out["seconds"] = seconds
    log("phase 16 (a) seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return out, run["launches"]


def mixtral_config(layers: int, **over):
    from deepspeed_tpu_torch import get_llama_config
    return get_llama_config("mixtral-8x7b", num_hidden_layers=layers, **over)


def mixtral_serving_phase(seed: int, card: str):
    """Phase 16 (b): Mixtral-8x7B at 8 of its 32 layers, bf16, random seeded
    weights, through ``init_inference(kernel_inject=True,
    use_flash_prefill=True)``: ``forward`` on [4, 2048], then ``generate`` of
    1 and of 64 greedy tokens after 4 prompts of 512, launch counts zeroed
    just before and read just after (K1 8 on the forward; K3 and K5 on
    every cached call); then the first prefill chunk's and decode step's
    logits at 2 layers, card against CPU."""
    from deepspeed_tpu_torch import LlamaForCausalLM, init_inference
    from deepspeed_tpu_torch.models.common import init_cache
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches
    from deepspeed_tpu_torch.testing import injected_routing

    out, seconds = {}, {}
    t_part = time.perf_counter()
    cfg = mixtral_config(MIXTRAL_SERVE_LAYERS, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed + 8))
    out["n_params"] = sum(p.numel() for p in model.parameters())
    engine = init_inference(model, dtype="bf16", kernel_inject=True, use_flash_prefill=True)
    del model
    torch.cuda.empty_cache()
    out["build_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rng = np.random.default_rng(seed + 8)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(4, 2048)), device="cuda")
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 512))
    engine.generate(prompts[:, :32], max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts zeroed just before, read just after ----
    reset_launches()
    t0 = time.perf_counter()
    logits = engine.forward(tokens)
    torch.cuda.synchronize()
    out["forward_s"] = time.perf_counter() - t0
    if logits.shape != (4, 2048, cfg.vocab_size) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"Mixtral forward: bad logits {tuple(logits.shape)}")
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
        raise AssertionError(f"Mixtral generate: bad output {tuple(generated.shape)}")
    if not torch.equal(generated[:, :513], first):
        raise AssertionError("Mixtral generate: the first token differs between the 1- and 64-token runs")
    layers = cfg.num_hidden_layers
    cached_calls = 512 // 16 + (512 // 16 + 63)  # prefill chunks of both generates, 63 token steps
    want = {"flash_fwd": layers, "flash_decode": cached_calls * layers,
            "moe_permute": 2 * layers * (1 + cached_calls)}
    if forward_counts["flash_fwd"] != layers or forward_counts["moe_permute"] != 2 * layers or \
            any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"Mixtral serving: launches {counts} (forward {forward_counts}), expected {want}")
    out.update(launches=counts, forward_launches=forward_counts, generate_s=gen_s, ttft_s=ttft,
               ms_per_token=(gen_s - ttft) / 63 * 1e3, tokens_per_s=4 * 64 / gen_s,
               forward_tokens_per_s=4 * 2048 / out["forward_s"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"mixtral serve: {layers} of 32 layers ({out['n_params']} params) bf16 forward [4,2048] "
        f"{out['forward_s']:.3f} s ({out['forward_tokens_per_s']:.1f} tokens/s); generate 4x64 after "
        f"512-token prompts {gen_s:.3f} s: {out['tokens_per_s']:.1f} tokens/s, {out['ms_per_token']:.2f} "
        f"ms per token step, TTFT {ttft * 1e3:.1f} ms; peak memory {out['peak_memory_gb']:.2f} GB "
        f"(build {out['build_peak_memory_gb']:.2f})  [{card}]")
    log(f"mixtral serve launches on the main path: {counts}")
    out["profile"] = _profile_generate(engine, prompts[:, :16], card)
    del engine
    torch.cuda.empty_cache()
    seconds["build, forward, generate, profile"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # the first prefill chunk and decode step at 2 layers of full width
    small = mixtral_config(2, dtype=torch.bfloat16, param_dtype=torch.bfloat16, attention_backend="flash")
    base = LlamaForCausalLM(small, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed + 9))
    state = {k: v.detach().cpu() for k, v in base.state_dict().items()}
    del base
    torch.cuda.empty_cache()
    ids = torch.as_tensor(prompts[:, :16])
    nxt, models = {}, {}

    def run_one(name, device, dtype, inject):
        m = models.get((device, dtype))
        if m is None:  # the plain fp32 model serves twice, each with a fresh cache
            with skipped_init():
                m = models[(device, dtype)] = LlamaForCausalLM(
                    dataclasses.replace(small, dtype=dtype, param_dtype=dtype), device=device)
            m.load_state_dict({k: v if k.endswith(".wg") else v.to(dtype) for k, v in state.items()},
                              strict=True)
        logits, used = {}, {}
        with torch.inference_mode():
            cache = init_cache(m, 4)
            for tick in ("prefill", "decode"):
                feed = ids if tick == "prefill" else nxt["tok"][:, None]
                with injected_routing(None if inject is None else inject[tick], model=m):
                    logits[tick] = m(feed.to(device), cache)[0][:, -1].float().cpu()
                used[tick] = _used_routing(m)
                if name == "plain_bf16" and tick == "prefill":
                    nxt["tok"] = logits[tick].argmax(-1)
        del cache
        return logits, used

    runs = _routed_runs("phase 16 (b) Mixtral 2-layer", SIDES, run_one)
    models.clear()
    _held_logits("phase 16 (b) Mixtral 2-layer", runs, out)
    seconds["2-layer card vs CPU"] = time.perf_counter() - t_part
    out["seconds"] = seconds
    log("phase 16 (b) seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return out, counts


def llama_active_params(n_params: int, cfg) -> int:
    """Parameters that compute per token: each MoE layer's E - k unused
    SwiGLU experts (3 H I parameters each) left out."""
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_hidden_layers))
    return n_params - moe_layers * (cfg.moe_num_experts - cfg.moe_k) * 3 * cfg.hidden_size * cfg.intermediate_size


def mixtral_train_phase(seed: int, card: str, warmup: int = 2, steps: int = 10):
    """Phase 16 (c): Mixtral-8x7B's width at ``MIXTRAL_TRAIN_LAYERS``
    layers through ``initialize`` and ``train_batch``: seq 4096,
    micro-batch 1, bf16 over fp32 masters, remat, the fused head on the [E,
    V] kernel (chunk 1024), the flash backend, AdamW lr 1e-4 wd 0.01,
    clipping 1.0, one seeded batch: 2 + 10 steps, K1 2, K4 1 and K5 6
    launches a step and layer asserted (dispatch and combine x forward,
    recompute and backward)."""
    from deepspeed_tpu_torch import LlamaForCausalLM, initialize
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches

    micro, seq = 1, 4096
    cfg = mixtral_config(MIXTRAL_TRAIN_LAYERS, remat=True, attention_backend="flash", dtype=torch.bfloat16,
                         fused_head_loss_chunk=1024)
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed + 10))
    engine, _, _, _ = initialize(model=model, config=train_config(micro, 1.0, True))
    n_params = sum(p.numel() for p in model.parameters())
    n_active = llama_active_params(n_params, cfg)
    rng = np.random.default_rng(seed + 10)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (micro, seq)).astype(np.int32)}
    torch.cuda.synchronize()

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
        raise AssertionError(f"Mixtral training: losses not finite and falling: {losses}")
    per_step = {k: c / (warmup + steps) for k, c in counts.items()}
    layers = cfg.num_hidden_layers
    want = {"flash_fwd": 2 * layers, "flash_bwd": layers, "moe_permute": 6 * layers}
    if any(per_step[k] != v for k, v in want.items()):
        raise AssertionError(f"Mixtral training: expected per step {want}, got {per_step}")
    step_ms = dt / steps * 1e3
    tokens_s = micro * seq * steps / dt
    fpt = flops_per_token(n_active, layers, cfg.hidden_size, seq)
    kept = [int(m.kept_counts.sum()) for m in _moe_layers(model)]
    out = dict(layers=layers, n_params=n_params, n_active_params=n_active, losses=losses, launches=counts,
               launches_per_step=per_step, kept_copies_last_step=kept, step_ms=step_ms,
               tokens_per_s=tokens_s, model_tflops=fpt * tokens_s / 1e12, flops_per_token=fpt,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               grad_norm=engine.get_global_grad_norm())
    log(f"mixtral train: {layers} layers of Mixtral-8x7B ({n_params} params, {n_active} active), seq {seq}, "
        f"micro-batch {micro}, bf16, remat, fused [E, V] head, flash, top-2 of 8; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {warmup}+{steps} steps; token copies kept per MoE layer {kept} of "
        f"{2 * micro * seq}  [{card}]")
    log(f"mixtral train: {step_ms:.2f} ms/step, {tokens_s:.1f} tokens/s, {out['model_tflops']:.2f} model "
        f"TFLOP/s by active parameters ({fpt:.4g} FLOP/token), peak memory {out['peak_memory_gb']:.2f} GB  [{card}]")
    log(f"mixtral train launches on the main path: {counts}; per step {per_step}  [{card}]")
    out["profile"] = _profile_train_step(engine, batch, card, step_ms)
    del engine, model
    torch.cuda.empty_cache()
    return out, counts


def mixtral_gradcheck_phase(seed: int, card: str) -> dict:
    """Phase 16 (d): one training forward and backward of Mixtral-8x7B's
    width at 2 layers (seq 256, batch 1, remat, flash, the fused head), on
    the card and on the CPU (plain versions), every side under the plain
    bf16 step's top-2 routing (its Gumbel second choices included),
    injected at the gate: fp32 card against fp32 plain, the loss and every
    gradient within 1e-4; bf16 card against bf16 plain within 1.5x the
    rounding of plain bf16 against plain fp32. The CPU's gradients wait on
    the card, so the host holds one model at a time."""
    from deepspeed_tpu_torch import LlamaForCausalLM
    from deepspeed_tpu_torch.testing import injected_routing

    kw = dict(remat=True, attention_backend="flash", fused_head_loss_chunk=1024, max_position_embeddings=256)
    base = LlamaForCausalLM(mixtral_config(2, **kw), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(seed + 11))
    state = {k: v.detach().cpu() for k, v in base.state_dict().items()}
    del base
    torch.cuda.empty_cache()
    vocab = mixtral_config(2).vocab_size
    ids = torch.as_tensor(np.random.default_rng(seed + 11).integers(0, vocab, (1, 256)).astype(np.int64))

    def one_step(device: str, dtype, routing=None):
        with skipped_init():
            model = LlamaForCausalLM(mixtral_config(2, dtype=dtype, **kw), device=device)
        model.load_state_dict(state, strict=True)
        gen = torch.Generator(device=device).manual_seed(seed)
        with injected_routing(routing, model=model):
            loss = model(ids.to(device), labels=ids.to(device), deterministic=False, generator=gen)
            loss.backward()
        grads = {"loss": loss.detach().float().reshape(1).cuda()}
        grads.update({n: p.grad.detach().float().cuda() for n, p in model.named_parameters()})
        used = _used_routing(model)
        del model
        return grads, used

    plain_bf16, fixed = one_step("cpu", torch.bfloat16)
    plain_fp32, _ = one_step("cpu", torch.float32, fixed)
    card_fp32, used = one_step("cuda", torch.float32, fixed)
    if _same_routing(used, fixed):
        raise AssertionError("Mixtral gradcheck fp32: the injected routing was not followed")
    for name, ref in plain_fp32.items():
        compare(f"mixtral gradcheck fp32 {name} (card vs plain, one routing)", card_fp32[name], ref,
                torch.float32)
    del card_fp32
    card_bf16, _ = one_step("cuda", torch.bfloat16, fixed)
    served = {n: rel_err(g, plain_bf16[n])[1] for n, g in card_bf16.items()}
    rounding = max(rel_err(g, plain_fp32[n])[1] for n, g in plain_bf16.items())
    worst = max(served, key=served.get)
    out = {"bf16_served_vs_plain_max_rel": served[worst], "bf16_served_worst_tensor": worst,
           "bf16_rounding_max_rel": rounding, "bf16_share_of_limit": served[worst] / (1.5 * rounding),
           "tokens": int(ids.numel()), "gates": sorted(fixed),
           "loss": {"plain_bf16": float(plain_bf16["loss"]), "plain_fp32": float(plain_fp32["loss"]),
                    "card_bf16": float(card_bf16["loss"])}}
    log(f"mixtral gradcheck: fp32 card vs plain within 1e-4 under one routing; bf16 card vs plain max rel "
        f"{served[worst]:.3e} ({worst}), {out['bf16_share_of_limit']:.3f} of the 1.5x-rounding limit (plain "
        f"bf16 vs plain fp32 max rel {rounding:.3e}); losses {out['loss']}  [{card}]")
    if not served[worst] <= 1.5 * rounding:
        raise AssertionError(f"mixtral gradcheck bf16: {served[worst]:.3e} > 1.5 x rounding {rounding:.3e}")
    RESULTS["checks"].append({"name": "mixtral gradcheck bf16 under one routing (1.5x rounding)",
                              "rel_err": served[worst], "tol": 1.5 * rounding, "ok": True})
    return out


def moe_phase(seed: int, card: str, k5: dict = None):
    """Phase 16: K5 at its new shapes (``k5``: timed already, beside phase
    3, where the whole script runs them while the profiler is fresh), then
    (a)-(d), each engine freed before the next. Returns (its numbers, the
    launch counts of the main paths (a)-(c) summed)."""
    out, total = {}, {}
    t0 = time.perf_counter()
    out["k5"] = k5 if k5 is not None else k5_routed_times(torch.Generator(device="cuda").manual_seed(seed + 12))
    parts = {}
    for key, fn in (("a_moe_scheduler", moe_scheduler_phase), ("b_mixtral_serving", mixtral_serving_phase),
                    ("c_mixtral_training", mixtral_train_phase)):
        t1 = time.perf_counter()
        out[key], counts = fn(seed, card)
        parts[key] = time.perf_counter() - t1
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["d_mixtral_gradcheck"] = mixtral_gradcheck_phase(seed, card)
    parts["d_mixtral_gradcheck"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    out["seconds_by_part"] = dict(parts, all=time.perf_counter() - t0)
    log("phase 16 seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds_by_part"].items()))
    return out, total


# ---------------------------------------------------------------------------
# phase 17: the RLHF hybrid engine and the rest of the inference engine
# ---------------------------------------------------------------------------
#: (a)'s rollouts: prompt and new tokens, slots, prefill chunk, learner batch
#: and rollouts; (b)'s beam search: batch, beams, prompt and new tokens
RLHF_PROMPT, RLHF_NEW, RLHF_SLOTS, RLHF_CHUNK = 64, 64, 8, 64
#: 16 rollouts (2 learner steps), cut from 32 to keep the script inside its
#: limit on a slow host (1149.4 s at 32)
RLHF_BATCH, RLHF_ROLLOUTS = 8, 16
BEAM_BATCH, BEAM_WIDTH, BEAM_PROMPT, BEAM_NEW = 4, 4, 64, 32
#: the kernels phase 17's paths must launch, and its beam search alone
RLHF_KERNELS = ("flash_fwd", "flash_bwd", "flash_decode", "quant_matmul")
BEAM_KERNELS = ("flash_fwd", "flash_decode")


def rlhf_config(**hybrid) -> dict:
    """The hybrid engine's config: the bench's optimizer and clipping, bf16
    over fp32 masters, the ``hybrid_engine`` block."""
    return dict(train_config(RLHF_BATCH, 1.0, True),
                hybrid_engine=dict({"enabled": True, "max_out_tokens": RLHF_PROMPT + RLHF_NEW},
                                   **hybrid))


def pg_loss(logits, batch):
    """The JAX RLHF test's policy-gradient loss: advantage-weighted
    log-likelihood of the rollout tokens, over the generated positions."""
    adv, mask = batch["advantage"], batch["mask"].float()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = torch.gather(logp, -1, batch["rollouts"][:, 1:, None].long())[..., 0]
    return -(adv[:, None] * tgt * mask[:, 1:]).sum() / mask[:, 1:].sum().clamp_min(1.0)


def rlhf_engine(seed: int):
    """GPT-2 350m (full width and depth, random weights from ``seed``) under
    the hybrid engine, on the ``"flash"`` backend."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, initialize
    cfg = get_gpt2_config("350m", dtype=torch.bfloat16, attention_backend="flash")
    model = GPT2LMHeadModel(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    return initialize(model=model, config=rlhf_config(), loss_fn=pg_loss, device="cuda")[0]


def rlhf_batch(exps) -> dict:
    """The learner batch of experiences: prompt + output padded to 128
    tokens, the generated positions masked in, reward = the share of output
    tokens of the prompt's last token's parity, centred: it varies from
    prompt to prompt even when a trained policy's outputs all look alike
    (the JAX test's even-token share went to one value for every rollout
    after one step on the card, and every later loss to 0)."""
    width = RLHF_PROMPT + RLHF_NEW
    toks = np.zeros((len(exps), width), np.int64)
    mask = np.zeros((len(exps), width), np.float32)
    for j, e in enumerate(exps):
        seq = np.asarray(e.tokens, np.int64)[:width]
        toks[j, :len(seq)] = seq
        mask[j, len(e.prompt):len(seq)] = 1.0
    reward = np.asarray([(np.asarray(e.output) % 2 == e.prompt[-1] % 2).mean() for e in exps],
                        np.float32)
    return {"input_ids": toks, "rollouts": toks, "advantage": reward - reward.mean(), "mask": mask}


def rlhf_prompts(seed: int, vocab: int):
    """The indexed prompt stream: prompt ``i`` is a pure function of (seed, i)."""
    from deepspeed_tpu_torch.inference.serving import Request

    def fn(i):
        r = np.random.RandomState(seed * 100003 + i)
        return Request(prompt=r.randint(0, vocab, size=(RLHF_PROMPT,)).astype(np.int32),
                       max_new_tokens=RLHF_NEW)
    return fn


def rlhf_serving(weight_dtype=None):
    from deepspeed_tpu_torch.inference.serving import ServingConfig
    return ServingConfig(slots=RLHF_SLOTS, prefill_chunk=RLHF_CHUNK, weight_dtype=weight_dtype)


def _timed_method(obj, name: str, into: list, after=None):
    """Wrap ``obj.name``: each call's seconds (the card synchronized) go
    into ``into``; ``after(result)`` runs on each result."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        if after is not None:
            after(out)
        return out

    setattr(obj, name, wrapped)


def rlhf_rollouts(seed: int, card: str, weight_dtype):
    """(a) one rollout run: a learner step and a synced generation for each
    8 rollouts, every sync digest-verified on fp weights. The fp run feeds
    cohort by cohort (``align_cohorts``): it is also the uninterrupted run
    the preemption check is held to. Returns (the engine, its numbers, the
    launch counts of the run)."""
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches
    from deepspeed_tpu_torch.runtime.rlhf import RolloutConfig, RolloutLoop
    label = weight_dtype or "fp"
    torch.cuda.reset_peak_memory_stats()
    engine = rlhf_engine(seed)
    learner_s, sync_s, verified = [], [], []
    _timed_method(engine, "train_batch", learner_s)
    loop = RolloutLoop(engine, rlhf_prompts(seed, engine.module.config.vocab_size), rlhf_batch,
                       RolloutConfig(train_batch_size=RLHF_BATCH, total_rollouts=RLHF_ROLLOUTS,
                                     sync_every=1, align_cohorts=weight_dtype is None),
                       serving_config=rlhf_serving(weight_dtype))
    _timed_method(engine, "sync_rollout_weights", sync_s,
                  after=lambda ev: verified.append(loop.scheduler.last_weight_sync["digest_verified"]))
    loop.scheduler.warmup()
    torch.cuda.synchronize()
    # ---- the main path: counts zeroed just before, read just after ----
    reset_launches()
    t0 = time.perf_counter()
    res = loop.run(max_ticks=10**5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    # ---- end of the main path ----
    losses = [r["loss"] for r in res["losses"]]
    steps = RLHF_ROLLOUTS // RLHF_BATCH
    if res["exit_code"] != 0 or res["learner_steps"] != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"rollouts ({label}): {res['exit_code']}, {res['learner_steps']} steps, "
                             f"losses {losses}")
    if res["weight_sync_generation"] != steps or engine.weight_sync_generation != steps:
        raise AssertionError(f"rollouts ({label}): weight_sync_generation "
                             f"{res['weight_sync_generation']}, want {steps}")
    if weight_dtype is None and not (len(verified) == steps and all(verified)):
        raise AssertionError(f"rollouts (fp): not every sync was digest-verified: {verified}")
    stats = res["scheduler_stats"]
    tokens = stats["generated_tokens"]
    rollout_s = wall - sum(learner_s) - sum(sync_s)
    ev = res["sync_evidence"]
    out = dict(losses=losses, wall_s=wall, learner_ms_per_step=[t * 1e3 for t in learner_s],
               sync_s=sync_s, execute_s=[e["execute_s"] for e in ev],
               digest_s=[e.get("digest_s") for e in ev], total_bytes=ev[0]["total_bytes"],
               digest_verified=verified, rollout_s=rollout_s, generated_tokens=tokens,
               rollout_tokens_per_s=tokens / rollout_s, ticks=stats["ticks"], launches=counts,
               rollout=stats["rollout"])
    log(f"rlhf (a) {label}: {steps} learner steps, losses {[f'{x:.4f}' for x in losses]}, "
        f"{tokens} tokens in {rollout_s:.2f} s of ticks ({out['rollout_tokens_per_s']:.1f} tokens/s), "
        f"learner {np.mean(learner_s) * 1e3:.1f} ms/step, syncs {[round(t, 3) for t in sync_s]} s "
        f"(execute_s {[round(x, 4) for x in out['execute_s']]}, digest_s "
        f"{[None if x is None else round(x, 3) for x in out['digest_s']]}), wall {wall:.2f} s, "
        f"ticks {stats['ticks']}  [{card}]")
    log(f"rlhf (a) {label} launches: {counts}")
    cfg = engine.module.config
    pool_shape = (RLHF_SLOTS, loop.scheduler.capacity, cfg.n_head, cfg.n_embd // cfg.n_head)
    prompts = [rlhf_prompts(seed + 1, cfg.vocab_size)(i).prompt for i in range(RLHF_SLOTS)]
    out["tick_profile"] = _profile_decode_ticks(loop.scheduler, prompts, card, pool_shape, n_ticks=5)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"rlhf (a) {label}: peak memory {out['peak_memory_gb']:.2f} GiB (training state, the bf16 "
        f"view, the slot cache{', the int8 view' if weight_dtype else ''})  [{card}]")
    del engine.train_batch, engine.sync_rollout_weights  # the class's methods again
    del loop
    return engine, out, counts


def rlhf_swap_check(engine, seed: int, card: str) -> dict:
    """A mid-decode swap of the same weights changes no token. On fp
    weights the rollout scheduler serves the view's own tensors, so that
    swap places nothing; a scheduler over an inference engine of its own
    (its weights zeroed) takes the view's weights by a copy, refuses a wrong
    digest, re-digests what it placed against the learner's digest, and
    then serves the view's tokens."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler
    fn = rlhf_prompts(seed + 2, engine.module.config.vocab_size)

    def outputs(sched, mid_swap=None):
        for i in range(RLHF_SLOTS):
            sched.submit(fn(i))
        for _ in range(4):   # the prefill tick and three decode ticks
            sched.step()
        if mid_swap is not None:
            mid_swap(sched)
            if not sched.last_weight_sync["digest_verified"]:
                raise AssertionError("the mid-decode swap was not digest-verified")
        sched.run_until_drained()
        return [list(map(int, r.output)) for r in sched.finished]

    want = outputs(engine.rollout_scheduler(rlhf_serving()))
    aliased = engine.rollout_scheduler(rlhf_serving())
    same = outputs(aliased, engine.sync_rollout_weights) == want
    RESULTS["checks"].append({"name": "rlhf mid-decode swap of the same weights", "ok": same})
    log(f"check rlhf mid-decode swap of the same weights: token-identical {same} (placed "
        f"{aliased.last_weight_sync['placed']})  [{card}]")
    if not same:
        raise AssertionError("a mid-decode swap of the same weights changed the rollouts")

    view = engine._infer_engine.params
    apart = init_inference(engine.module, dtype=torch.bfloat16, replace_with_kernel_inject=False,
                           max_tokens=RLHF_PROMPT + RLHF_NEW, device="cuda")
    with torch.no_grad():
        for t in apart.module.state_dict().values():
            t.zero_()
    sched = ContinuousBatchingScheduler(apart, rlhf_serving())
    try:
        sched.swap_served_params(view, expected_digest="0" * 64)
        refused = False
    except ValueError:
        refused = True
    learner = engine.last_weight_sync
    t0 = time.perf_counter()
    sched.swap_served_params(view, expected_digest=learner["digest"], evidence=learner)
    swap_s = time.perf_counter() - t0
    placed = sched.last_weight_sync
    served = outputs(sched)
    del sched, apart
    torch.cuda.empty_cache()
    ok = refused and placed["placed"] and placed["digest_verified"] and served == want
    RESULTS["checks"].append({"name": "rlhf swap into a scheduler's own tensors", "ok": ok,
                              "wrong_digest_refused": refused, "swap_s": swap_s})
    log(f"check rlhf swap into a scheduler's own tensors (zeroed): wrong digest refused {refused}, "
        f"placed {placed['placed']}, digest-verified {placed['digest_verified']} in {swap_s:.3f} s, "
        f"token-identical to the view's {served == want}  [{card}]")
    if not ok:
        raise AssertionError("a swap into a scheduler's own tensors was not placed and verified")
    return {"token_identical": same, "apart_swap_s": swap_s}


def rlhf_isolation_check(seed: int, card: str) -> dict:
    """train -> generate -> train gives the loss bits of train -> train,
    both from one snapshot of a fresh engine (parameters, Adam state,
    counters and generator restored between them)."""
    from deepspeed_tpu_torch.runtime.rlhf import Experience
    # rewards 1 and 0 in turn: a nonzero advantage on every row
    batch = rlhf_batch([Experience(index=i, prompt=list(range(RLHF_PROMPT)),
                                   output=[i + 1] * RLHF_NEW, weight_generation=0)
                        for i in range(RLHF_BATCH)])
    engine = rlhf_engine(seed + 3)
    prompts = np.random.default_rng(seed).integers(0, engine.module.config.vocab_size,
                                                   (2, RLHF_PROMPT))
    snap = _snapshot(engine)

    def run(with_generate):
        _restore(engine, snap)
        losses = []
        for step in range(3):
            losses.append(float(engine.train_batch(batch)))
            if with_generate and step == 0:
                engine.generate(prompts, max_new_tokens=RLHF_NEW // 2)
                engine.infer_forward(prompts)
        return losses, engine.generator.get_state()

    control, mixed = run(False), run(True)
    del engine, snap
    torch.cuda.empty_cache()
    same = control[0] == mixed[0] and torch.equal(control[1], mixed[1])
    RESULTS["checks"].append({"name": "rlhf train-generate-train bits", "ok": same,
                              "train_train": control[0], "train_generate_train": mixed[0]})
    log(f"check rlhf train -> generate -> train vs train -> train over 3 steps: loss bits equal "
        f"{same} ({control[0]} vs {mixed[0]})  [{card}]")
    if not same:
        raise AssertionError("generation perturbed training")
    return {"losses": control[0], "bit_equal": same}


def rlhf_preempt_check(seed: int, card: str, work: str, want: list) -> dict:
    """(a)'s fp run again, with a flag after learner step 1: it drains
    (nothing dropped) and checkpoints once; (d) serves that tag from the
    preempted engine; a fresh engine's resume and restore finish with
    ``want``, the uninterrupted fp run's loss bits (``align_cohorts``).
    Returns (the preemption's numbers, (d)'s)."""
    from deepspeed_tpu_torch.runtime.resilience.signals import PreemptionGuard
    from deepspeed_tpu_torch.runtime.rlhf import RolloutConfig, RolloutLoop

    def loop_for(engine, **kw):
        return RolloutLoop(engine, fn, rlhf_batch,
                           RolloutConfig(train_batch_size=RLHF_BATCH, total_rollouts=RLHF_ROLLOUTS,
                                         sync_every=1, align_cohorts=True, **kw),
                           serving_config=rlhf_serving())

    engine = rlhf_engine(seed)
    fn = rlhf_prompts(seed, engine.module.config.vocab_size)
    guard = PreemptionGuard(signals=[])   # flag-only trigger
    ckpt = os.path.join(work, "rlhf")
    loop = loop_for(engine, checkpoint_dir=ckpt)
    orig = engine.train_batch

    def train_then_flag(b):
        loss = orig(b)
        guard.request("flag")
        return loss

    engine.train_batch = train_then_flag
    save_s = []
    _timed_method(engine, "save_checkpoint", save_s)
    t0 = time.perf_counter()
    first = loop.run(guard=guard)
    preempt_s = time.perf_counter() - t0
    del loop
    if not (first["exit_code"] == 143 and first["dropped"] == 0 and first["learner_steps"] == 1
            and len(save_s) == 1):
        raise AssertionError(f"rlhf preemption: exit {first['exit_code']}, dropped "
                             f"{first['dropped']}, {first['learner_steps']} steps, "
                             f"{len(save_s)} saves")
    served = rlhf_checkpoint_phase(engine, card, work, ckpt, first["checkpoint_tag"], save_s[0])
    del engine
    torch.cuda.empty_cache()
    fresh = rlhf_engine(seed + 5)   # another init: every bit must come from the tag
    t0 = time.perf_counter()
    tag, client = fresh.resume(ckpt)
    resume_s = time.perf_counter() - t0
    loop = loop_for(fresh)
    if not loop.restore(client):
        raise AssertionError("rlhf preemption: the tag carries no loop state")
    second = loop.run()
    del loop, fresh
    torch.cuda.empty_cache()
    stitched = [r["loss"] for r in first["losses"] + second["losses"]]
    disjoint = {r["step"] for r in first["losses"]}.isdisjoint(r["step"] for r in second["losses"])
    ok = stitched == want and disjoint and second["exit_code"] == 0
    RESULTS["checks"].append({"name": "rlhf preempt, resume, stitched loss bits", "ok": ok,
                              "stitched": stitched, "uninterrupted": want})
    log(f"check rlhf preemption: exit 143, dropped 0, tag {tag} ({preempt_s:.1f} s with the drain "
        f"and the {save_s[0]:.1f} s save, resume {resume_s:.1f} s); stitched losses {stitched} vs "
        f"uninterrupted {want}: {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        raise AssertionError("the resumed rollout run does not finish with the uninterrupted bits")
    return {"tag": tag, "stitched": stitched, "preempt_s": preempt_s, "save_s": save_s[0],
            "resume_s": resume_s}, served


def _beam_score(module, ids: np.ndarray, prompt_len: int) -> np.ndarray:
    """Each row's mean log-probability of its generated tokens under
    ``module`` (one forward over prompt + generated; length penalty 1)."""
    with torch.inference_mode():
        logits = module(torch.as_tensor(ids.astype(np.int64), device="cuda")).float()
    lp = torch.log_softmax(logits[:, prompt_len - 1:-1], dim=-1)
    tok = torch.as_tensor(ids[:, prompt_len:].astype(np.int64), device="cuda")
    return torch.gather(lp, -1, tok[..., None])[..., 0].mean(-1).cpu().numpy()


def rlhf_beam_phase(seed: int, card: str):
    """(b) beam search on 350m: the flash engine (K1 ``forward``, K3 every
    step) against the ``"xla"`` backend, token for token in fp32; in bf16
    by the margin rule on sequence scores. Returns (numbers, launches)."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches
    cfg = get_gpt2_config("350m")
    model = GPT2LMHeadModel(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed + 6))
    prompts = np.random.default_rng(seed + 6).integers(0, cfg.vocab_size, (BEAM_BATCH, BEAM_PROMPT))
    kw = dict(max_new_tokens=BEAM_NEW, num_beams=BEAM_WIDTH)
    out, runs = {}, {}
    for dtype in ("fp32", "bf16"):
        for backend in ("flash", "xla"):
            inject = dict(kernel_inject=True, use_flash_prefill=True) if backend == "flash" else {}
            engine = init_inference(model, dtype=dtype, **inject)
            engine.generate(prompts[:, :16], max_new_tokens=2, num_beams=BEAM_WIDTH)  # warm
            torch.cuda.synchronize()
            counts = None
            if backend == "flash" and dtype == "bf16":
                # ---- the main path: counts zeroed just before, read just after ----
                reset_launches()
                logits = engine.forward(prompts)
                t0 = time.perf_counter()
                got = engine.generate(prompts, **kw).numpy()
                torch.cuda.synchronize()
                gen_s = time.perf_counter() - t0
                counts = launches()
                # ---- end of the main path ----
                out.update(generate_s=gen_s, tokens_per_s=BEAM_BATCH * BEAM_NEW / gen_s,
                           beam_tokens_per_s=BEAM_BATCH * BEAM_WIDTH * BEAM_NEW / gen_s, launches=counts)
                if not torch.isfinite(logits.float()).all():
                    raise AssertionError("beam (b): non-finite forward logits")
                del logits
            else:
                got = engine.generate(prompts, **kw).numpy()
            if got.shape != (BEAM_BATCH, BEAM_PROMPT + BEAM_NEW) or not (got[:, :BEAM_PROMPT] == prompts).all():
                raise AssertionError(f"beam (b) {backend} {dtype}: bad output {got.shape}")
            runs[(backend, dtype)] = (got, counts, engine if backend == "xla" else None)
            if backend == "flash":
                del engine
            torch.cuda.empty_cache()
    counts = runs[("flash", "bf16")][1]
    missing = [k for k in BEAM_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"beam (b): kernels never launched: {missing} ({counts})")
    same32 = bool((runs[("flash", "fp32")][0] == runs[("xla", "fp32")][0]).all())
    RESULTS["checks"].append({"name": "beam fp32 flash vs xla token-identical", "ok": same32})
    log(f"check beam (b) fp32: flash engine vs xla engine token-identical {same32}  [{card}]")
    if not same32:
        raise AssertionError("beam search in fp32 differs between the kernels and the xla backend")
    # bf16: the rounding this run measures (xla bf16 vs xla fp32 logits)
    x16, x32 = runs[("xla", "bf16")][2], runs[("xla", "fp32")][2]
    with torch.inference_mode():
        l16 = x16.forward(prompts).float()
        l32 = x32.forward(prompts).float()
    rounding = rel_err(l16, l32)[1]
    maxabs = l32.abs().max().item()
    del l16, l32
    ref, got = runs[("xla", "bf16")][0], runs[("flash", "bf16")][0]
    rows = []
    for i in range(BEAM_BATCH):
        if (ref[i] == got[i]).all():
            continue
        s = _beam_score(x32.module, np.stack([ref[i], got[i]]), BEAM_PROMPT)
        # two bf16 searches, each step's log-probability off by at most
        # twice the logit rounding: their fp32 scores may differ by 4x
        limit = 4 * 1.5 * rounding * maxabs
        rows.append(dict(row=i, position=first_divergence(list(ref[i]), list(got[i])),
                         score_gap=float(s[0] - s[1]), limit=limit, ok=float(s[0] - s[1]) <= limit))
    ok = all(r["ok"] for r in rows)
    share = margin_share(x16.module, [(p, None) for p in prompts],
                         [list(r[BEAM_PROMPT:]) for r in ref], rounding)
    RESULTS["checks"].append({"name": "beam bf16 flash vs xla (margin rule on scores)", "ok": ok,
                              "divergent": rows})
    log(f"check beam (b) bf16: {BEAM_BATCH - len(rows)}/{BEAM_BATCH} rows token-identical; divergent "
        f"{[(r['row'], r['position'], round(r['score_gap'], 5), round(r['limit'], 5)) for r in rows]} "
        f"(row, position, fp32 score gap of the reference over the kernels' beam, limit) "
        f"{'ok' if ok else 'FAIL'}; rounding {rounding:.3e}; share of the reference's positions "
        f"within the margin rule's limit {share['share_within_limit']:.3f}  [{card}]")
    if not ok:
        raise AssertionError(f"beam (b) bf16: a divergence beyond the margin rule: {rows}")
    out.update(fp32_identical=same32, bf16_divergent=rows, rounding=rounding, margin_share=share)
    log(f"rlhf (b) beam search batch {BEAM_BATCH} x {BEAM_WIDTH} beams, prompt {BEAM_PROMPT}, "
        f"{BEAM_NEW} new: {out['generate_s']:.3f} s, {out['tokens_per_s']:.1f} tokens/s of the best "
        f"beams ({out['beam_tokens_per_s']:.1f} of all hypotheses); launches K1 "
        f"{counts['flash_fwd']}, K3 {counts['flash_decode']}  [{card}]")
    del runs, x16, x32
    torch.cuda.empty_cache()
    return out, counts


def _weight_bytes(params: dict, scales=None) -> int:
    n = sum(t.numel() * t.element_size() for t in params.values())
    return n + sum(t.numel() * t.element_size() for t in (scales or {}).values())


def rlhf_int8_phase(seed: int, card: str):
    """(c) engine-wide int8 (``dtype="int8"`` and ``quant.enabled``) on
    350m against the bf16 engine. Returns (numbers, launches)."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches
    cfg = get_gpt2_config("350m")
    model = GPT2LMHeadModel(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed + 7))
    ids = np.random.default_rng(seed + 7).integers(0, cfg.vocab_size, (4, 256))
    inject = dict(kernel_inject=True, use_flash_prefill=True)
    ref = init_inference(model, dtype="bf16", **inject)
    with torch.inference_mode():
        lr = ref.forward(ids).float()
    bf16_bytes = _weight_bytes(ref.params)
    del ref
    out, total = {"bf16_weight_bytes": bf16_bytes}, {}
    for how, kw in (("dtype_int8", dict(dtype="int8")),
                    ("quant_block", dict(dtype="bf16", quant={"enabled": True}))):
        engine = init_inference(model, **inject, **kw)
        int8 = [k for k, v in engine.params.items() if v.dtype == torch.int8]
        if not int8 or not all(engine.params[k].is_cuda for k in int8):
            raise AssertionError(f"int8 (c) {how}: no int8 leaf on the card")
        # ---- the main path: counts zeroed just before, read just after ----
        reset_launches()
        lq = engine.forward(ids).float()
        gen = engine.generate(ids[:2, :64], max_new_tokens=16)
        torch.cuda.synchronize()
        counts = launches()
        # ---- end of the main path ----
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        corr = float(np.corrcoef(lr.cpu().numpy().ravel(), lq.cpu().numpy().ravel())[0, 1])
        agree_last = float((lr[:, -1].argmax(-1) == lq[:, -1].argmax(-1)).float().mean())
        agree_all = float((lr.argmax(-1) == lq.argmax(-1)).float().mean())
        nbytes = _weight_bytes(engine.params, engine._wq_scales)
        ok = corr > 0.99 and agree_all >= 0.5 and tuple(gen.shape) == (2, 80)
        RESULTS["checks"].append({"name": f"int8 engine ({how}) vs bf16", "ok": ok, "corr": corr,
                                  "top1_agreement": agree_all})
        log(f"check int8 (c) {how}: {len(int8)} int8 leaves on the card, logits correlation with "
            f"the bf16 engine {corr:.5f} (> 0.99), top-1 agreement {agree_all:.3f} over all "
            f"positions (>= 0.5; last positions {agree_last:.2f}); weights {nbytes / 2**20:.1f} MiB "
            f"vs bf16 {bf16_bytes / 2**20:.1f} MiB; generate {tuple(gen.shape)}; launches {counts} "
            f"{'ok' if ok else 'FAIL'}  [{card}]")
        if not ok:
            raise AssertionError(f"int8 (c) {how}: corr {corr}, agreement {agree_all}")
        out[how] = dict(int8_leaves=len(int8), corr=corr, top1_agreement=agree_all,
                        top1_agreement_last=agree_last, weight_bytes=nbytes, launches=counts)
        del engine, lq
        torch.cuda.empty_cache()
    return out, total


def rlhf_checkpoint_phase(engine, card: str, work: str, ckpt: str, tag: str, save_s: float) -> dict:
    """(d) serving from a hybrid engine's checkpoints: the tag it has just
    saved under ``ckpt`` (directory and dict spec) in fp32 against its live
    parameters, and its 16-bit npz against the live parameters rounded to
    bf16, within 1e-5."""
    from deepspeed_tpu_torch import init_inference
    ids = np.random.default_rng(8).integers(0, engine.module.config.vocab_size, (2, 256))
    deploy = os.path.join(work, "deploy")
    npz = engine.save_16bit_model(deploy)
    live = {k: v.detach().clone() for k, v in engine.module.state_dict().items()}

    def logits(**source):
        t0 = time.perf_counter()
        served = init_inference(engine.module, dtype="fp32", kernel_inject=True, use_flash_prefill=True,
                                **source)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        with torch.inference_mode():
            out = served.forward(ids).float()
        del served
        return out, load_s

    want, _ = logits(params=live)
    out = {"save_s": save_s, "tag": tag}
    for name, source, ref in (("tag dir", dict(checkpoint=ckpt), want),
                              ("dict spec", dict(checkpoint={"checkpoint_dir": ckpt, "tag": tag}), want),
                              ("16-bit npz", dict(checkpoint=deploy), None)):
        if ref is None:
            ref, _ = logits(params={k: v.to(torch.bfloat16).float() for k, v in live.items()})
        got, load_s = logits(**source)
        err = (got - ref).abs().max().item()
        ok = err <= 1e-5 and torch.isfinite(got).all().item()
        rel32 = rel_err(got, want)[1]
        RESULTS["checks"].append({"name": f"checkpoint serving ({name})", "max_abs_err": err, "ok": ok})
        log(f"check checkpoint (d) {name}: fp32 logits max |err| {err:.3e} (<= 1e-5) against the "
            f"{'live parameters' if ref is want else 'live parameters rounded to bf16'} "
            f"(rel {rel32:.3e} against the fp32 live ones); load {load_s:.2f} s "
            f"{'ok' if ok else 'FAIL'}  [{card}]")
        if not ok:
            raise AssertionError(f"checkpoint (d) {name}: max |err| {err}")
        out[name] = dict(max_abs_err=err, rel_vs_fp32_live=rel32, load_s=load_s)
    out["npz_bytes"] = os.path.getsize(npz)
    log(f"checkpoint (d): the tag's save {save_s:.2f} s ({tag}), npz {out['npz_bytes'] / 2**20:.1f} "
        f"MiB  [{card}]")
    shutil.rmtree(deploy, ignore_errors=True)
    return out


def rlhf_paged_kv_phase(seed: int, card: str) -> dict:
    """(e) ``PagedKVCache`` at 350m's per-layer shape: int8 pages of 16, 3
    sequences appended across page edges, gathered; K3 on the gathered
    view against its plain version."""
    from deepspeed_tpu_torch.inference import PagedKVCache
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    cache = PagedKVCache(num_pages=64, page_size=16, num_heads=16, head_dim=64, dtype=torch.bfloat16,
                         quantize=True, device="cuda")
    lengths = (40, 17, 100)
    for s, n in enumerate(lengths):
        cache.allocate(s)
        for lo in range(0, n, 7):   # runs of 7 tokens: most cross a page edge
            t = min(7, n - lo)
            cache.append(s, torch.randn(t, 16, 64, generator=gen, device="cuda").to(torch.bfloat16),
                         torch.randn(t, 16, 64, generator=gen, device="cuda").to(torch.bfloat16))
    k, v, lens = cache.gather([0, 1, 2], pad_to=128)
    if lens.tolist() != list(lengths) or tuple(k.shape) != (3, 128, 16, 64):
        raise AssertionError(f"paged KV (e): lengths {lens.tolist()}, view {tuple(k.shape)}")
    k, v = k.contiguous(), v.contiguous()
    q = torch.randn(3, 1, 16, 64, generator=gen, device="cuda").to(torch.bfloat16)
    err = compare("paged KV (e) K3 on the gathered view", fa.flash_decode(q, k, v, lens),
                  fa.flash_decode_plain(q, k, v, lens, scale=0.125), torch.bfloat16)
    counters = cache.counters()
    log(f"paged KV (e): {sum(lengths)} tokens in {64 - cache.free_pages} pages of 16, counters "
        f"{counters}  [{card}]")
    return {"max_abs_err": err, "counters": counters, "pages_used": 64 - cache.free_pages}


def rlhf_kernel_times(gen) -> dict:
    """K2 at the rollout's prefill tick (M = 8 slots x 64 = 512, int8, every
    350m projection) and K3 at the beam step (q [16,1,16,64]: batch 4 x 4
    beams, over a bf16 [16,1024,16,64] cache with 95 live rows, the last
    step's), timed as phase 3 times them: kernel, plain version, library
    call (device-side) and bound."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import quant_matmul as qm
    dev = torch.device("cuda")
    out = {"quant_matmul": {}, "flash_decode": {}}
    m = RLHF_SLOTS * RLHF_CHUNK
    for kk, n in K2_SHAPES:
        x, qw, scale, codes, g = k2_operands(gen, m, kk, n, 8)
        w = (codes.float().reshape(g, kk // g, n) * scale[:, None, :]).reshape(kk, n).to(torch.bfloat16)
        copies, nxt = rotating(lambda: (qw.clone(), scale.clone(), w.clone()), qw.numel() + scale.numel() * 4)
        kernel = lambda: qm.quant_matmul(x, *nxt()[:2], bits=8)  # noqa: E731
        library = lambda: torch.matmul(x, nxt()[2])  # noqa: E731
        got, ref = qm.quant_matmul(x, qw, scale, bits=8), qm.quant_matmul_plain(x, qw, scale, 8)
        err = compare(f"K2 rollout prefill M={m} K={kk} N={n}", got, ref, torch.bfloat16)
        nbytes = m * kk * 2 + qw.numel() + scale.numel() * 4 + m * n * 2
        bnd, by = bound_ms(nbytes, 2 * m * kk * n)
        entry = dict(shape=f"x [{m},{kk}] bf16 @ int8 [{kk},{n}], scales [{g},{n}]", max_abs_err=err,
                     ms=time_ms(kernel, iters=len(copies)), device_ms=device_ms(kernel, iters=len(copies)),
                     plain_ms=time_ms(lambda: qm.quant_matmul_plain(x, qw, scale, 8), iters=10),
                     library_ms=device_ms(library, iters=len(copies)), bound_ms=bnd, bound_by=by)
        out["quant_matmul"][f"int8 M={m} K={kk} N={n}"] = entry
        log(f"time quant_matmul rollout prefill int8 M={m} K={kk} N={n}: kernel_ms={entry['ms']:.4f} "
            f"kernel_device_ms={entry['device_ms']:.4f} plain_ms={entry['plain_ms']:.4f} "
            f"library_ms={entry['library_ms']:.4f} bound_ms={bnd:.4f} ({by})")
        del copies
    s, live = BEAM_BATCH * BEAM_WIDTH, BEAM_PROMPT + BEAM_NEW - 1
    q = torch.randn(s, 1, 16, 64, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(s, P, 16, 64, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    lens = torch.full((s,), live, dtype=torch.int32, device=dev)
    kernel = lambda: fa.flash_decode(q, k, v, lens)  # noqa: E731
    err = compare(f"K3 beam step q [{s},1,16,64]", kernel(), fa.flash_decode_plain(q, k, v, lens, scale=0.125),
                  torch.bfloat16)
    mask = (torch.arange(P, device=dev)[None, None, None, :] < live)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
    nbytes = s * live * 16 * 64 * 2 * 2 + 2 * q.numel() * 2 + s * 4
    bnd, by = bound_ms(nbytes, 4 * 64 * 16 * s * live)
    entry = dict(shape=f"q [{s},1,16,64], k/v [{s},1024,16,64] bf16, {live} live rows each",
                 max_abs_err=err, ms=time_ms(kernel, iters=50), device_ms=device_ms(kernel),
                 plain_ms=time_ms(lambda: fa.flash_decode_plain(q, k, v, lens, scale=0.125), iters=5, warmup=1),
                 library_ms=device_ms(sdpa), bound_ms=bnd, bound_by=by)
    out["flash_decode"][f"beam step Lq=1 S={s}"] = entry
    log(f"time flash_decode beam step q [{s},1,16,64] ({live} live rows): kernel_ms={entry['ms']:.4f} "
        f"kernel_device_ms={entry['device_ms']:.4f} plain_ms={entry['plain_ms']:.4f} "
        f"library_ms={entry['library_ms']:.4f} (masked SDPA, device-side) bound_ms={bnd:.4f} ({by})")
    return out


def rlhf_phase(seed: int, card: str, times: dict = None):
    """Phase 17: K2 and K3 at the phase's new shapes (``times``: timed
    already, beside phase 3, where the whole script runs them while the
    profiler is fresh), then (a)-(e). Returns (its numbers, the launch
    counts of its main paths summed: (a) both runs, (b) and (c))."""
    out, total, parts = {}, {}, {}
    t0 = time.perf_counter()
    out["kernel_times"] = times if times is not None else rlhf_kernel_times(
        torch.Generator(device="cuda").manual_seed(seed + 10))
    parts["kernel times"] = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="chip_smoke_rlhf_")
    try:
        t1 = time.perf_counter()
        runs = {}
        for weight_dtype in ("int8", None):
            engine, runs[weight_dtype or "fp"], counts = rlhf_rollouts(seed, card, weight_dtype)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            if weight_dtype is not None:
                del engine
                torch.cuda.empty_cache()
        out["a_rollouts"] = runs
        out["a_swap"] = rlhf_swap_check(engine, seed, card)
        del engine
        torch.cuda.empty_cache()
        parts["a rollouts"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["a_isolation"] = rlhf_isolation_check(seed, card)
        out["a_preempt"], out["d_checkpoints"] = rlhf_preempt_check(
            seed, card, work, runs["fp"]["losses"])
        parts["a isolation, preemption and (d) checkpoints"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for key, fn in (("b_beam", rlhf_beam_phase), ("c_int8", rlhf_int8_phase)):
        t1 = time.perf_counter()
        out[key], counts = fn(seed, card)
        parts[key] = time.perf_counter() - t1
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    t1 = time.perf_counter()
    out["e_paged_kv"] = rlhf_paged_kv_phase(seed, card)
    parts["e paged kv"] = time.perf_counter() - t1
    missing = [k for k in RLHF_KERNELS if total.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase 17: kernels never launched on its paths: {missing} ({total})")
    out["launches"] = total
    out["seconds_by_part"] = dict(parts, all=time.perf_counter() - t0)
    log("phase 17 seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds_by_part"].items()))
    return out, total



# ---------------------------------------------------------------------------
# phase 18: the serving fleet
# ---------------------------------------------------------------------------
#: phase 18's trace: 16 greedy requests of 64 new tokens (cut from 32 for
#: the script's time limit), served by replicas of 8 slots
FLEET_REQUESTS, FLEET_NEW, FLEET_SLOTS = 16, 64, 8
#: the kernels phase 18 (a)'s path runs (int8 weights: K2; the flash backend: K3)
FLEET_KERNELS = ("quant_matmul", "flash_decode")
#: the subprocess workers' knobs (GPT-2 350m at its full context, 8 slots;
#: the rest the worker's defaults, the JAX package's)
FLEET_WORKER_ENV = {"FLEET_MODEL": "350m", "FLEET_POSITIONS": "1024", "FLEET_SLOTS": "8"}
#: the fields of a replica's tick signals that tell one scheduler state from
#: another (the autoscaler reads a subset)
STATE_KEYS = ("queue_depth", "in_flight", "slots", "free_slots", "finished", "ttft_p50", "ttft_p99",
              "pool_free_blocks", "pool_fragmentation_tokens", "cached_blocks")


def fleet_trace(rng, vocab: int, n: int = FLEET_REQUESTS, templates: int = 4, prefix: int = 256) -> list:
    """``n`` greedy requests of ``FLEET_NEW`` new tokens, prompts of 64-512
    tokens from ``templates`` shared ``prefix``-token prefixes (a prompt
    shorter than the prefix is its head)."""
    shared = [rng.integers(0, vocab, size=prefix).astype(np.int32) for _ in range(templates)]
    trace = []
    for _ in range(n):
        length = int(rng.integers(64, 513))
        base = shared[int(rng.integers(0, templates))]
        tail = rng.integers(0, vocab, size=max(0, length - prefix)).astype(np.int32)
        trace.append((np.concatenate([base[:length], tail]), FLEET_NEW))
    return trace


def _percentiles_ms(xs: list) -> dict:
    return dict(n=len(xs), p50_ms=float(np.percentile(xs, 50)) * 1e3 if xs else None,
                p99_ms=float(np.percentile(xs, 99)) * 1e3 if xs else None)


def _differing_positions(ref: list, got: list) -> int:
    """Positions where two runs' tokens differ, over every request."""
    return sum(sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b)) for a, b in zip(ref, got))


@contextlib.contextmanager
def kernel_operands(into: dict):
    """Record into ``into`` the operands of K2's and K3's first call at each
    (shape, dtype, operand form) while the block runs: the calls the main
    path makes, to hold against the plain versions afterwards."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import quant_matmul as qm
    qmm, decode = qm.quant_matmul, fa.flash_decode

    def quant_matmul(x, qw, scale, *, bits=8):
        key = ("quant_matmul", tuple(x.shape), tuple(qw.shape), str(x.dtype).removeprefix("torch."))
        if key not in into:
            into[key] = dict(args=(x.clone(), qw, scale), kw=dict(bits=bits))
        return qmm(x, qw, scale, bits=bits)

    def flash_decode(q, k, v, lengths, *, scale=None, k_scale=None, v_scale=None):
        key = ("flash_decode", tuple(q.shape), tuple(k.shape), str(q.dtype).removeprefix("torch."),
               "int8" if k_scale is not None else "values")
        if key not in into:
            clone = lambda t: None if t is None else t.clone()  # noqa: E731
            into[key] = dict(args=(q.clone(), k.clone(), v.clone(), lengths.clone()),
                             kw=dict(scale=scale, k_scale=clone(k_scale), v_scale=clone(v_scale)))
        return decode(q, k, v, lengths, scale=scale, k_scale=k_scale, v_scale=v_scale)

    qm.quant_matmul, fa.flash_decode = quant_matmul, flash_decode
    try:
        yield into
    finally:
        qm.quant_matmul, fa.flash_decode = qmm, decode


def check_kernel_operands(calls: dict, card: str) -> dict:
    """Each recorded K2 and K3 call against its plain version on the same
    operands (2e-2 bf16, 1e-4 fp32 of max |ref|), and its time beside the
    plain version's, one library call's (K2: a matmul over the dequantised
    weight in x's dtype; K3: masked SDPA over the dequantised pool, the
    dequantise not timed) and the bound (bytes over 3.35 TB/s or operations
    over the dtype's peak: 989 TFLOP/s bf16, 67 TFLOP/s fp32)."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import quant_matmul as qm
    out = {}
    for key, call in sorted(calls.items(), key=lambda kv: str(kv[0])):
        name, dtype_name = key[0], key[3]
        dtype = getattr(torch, dtype_name)
        rate = PEAK_BF16_FLOP_S if dtype == torch.bfloat16 else PEAK_FP32_FLOP_S
        args, kw = call["args"], call["kw"]
        if name == "quant_matmul":
            x, qw, scale = args
            m, kk = x.shape
            n = qw.shape[1]
            g = scale.shape[0]
            kernel = lambda: qm.quant_matmul(x, qw, scale, **kw)  # noqa: E731
            plain = lambda: qm.quant_matmul_plain(x, qw, scale, kw["bits"])  # noqa: E731
            w = (qw.float().reshape(g, kk // g, n) * scale[:, None, :]).reshape(kk, n).to(dtype)
            library = lambda: torch.matmul(x, w)  # noqa: E731
            nbytes = x.numel() * x.element_size() + qw.numel() + scale.numel() * 4 + m * n * x.element_size()
            bnd, by = bound_ms(nbytes, 2 * m * kk * n, rate)
            shape = f"x [{m},{kk}] {dtype_name} @ int8 [{kk},{n}], scales [{g},{n}]"
        else:
            q, k, v, lens = args
            s, lq, h, d = q.shape
            kernel = lambda: fa.flash_decode(q, k, v, lens, **kw)  # noqa: E731
            plain = lambda: fa.flash_decode_plain(q, k, v, lens, **dict(kw, scale=kw["scale"] or d ** -0.5))  # noqa: E731
            if kw["k_scale"] is not None:
                kd, vd = fa.dequantize_kv(k, kw["k_scale"], dtype), fa.dequantize_kv(v, kw["v_scale"], dtype)
            else:
                kd, vd = k, v
            p_len = k.shape[1]
            kpos = torch.arange(p_len, device=q.device)
            qpos = lens.long()[:, None] - lq + torch.arange(lq, device=q.device)[None, :]
            mask = ((kpos[None, None, :] <= qpos[:, :, None])
                    & (kpos[None, None, :] < lens.long().clamp(0, p_len)[:, None, None]))[:, None]
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kd, vd))
            library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
            lengths = lens.tolist()
            live = sum(min(max(x, 0), p_len) for x in lengths)
            per_row = h * d * k.element_size() + (h * kw["k_scale"].element_size() if kw["k_scale"] is not None else 0)
            nbytes = 2 * live * per_row + 2 * q.numel() * q.element_size() + lens.numel() * lens.element_size()
            pairs = sum(max(0, min(min(max(x, 0), p_len), x - lq + r + 1)) for x in lengths for r in range(lq))
            bnd, by = bound_ms(nbytes, 4 * d * h * pairs, rate)
            shape = (f"q [{s},{lq},{h},{d}] {dtype_name}, k/v [{s},{p_len},{h},{d}] {key[4]}, "
                     f"live rows {live}")
        label = f"phase 18 {name} {shape}"
        err = compare(label, kernel(), plain(), dtype)
        row = dict(name=name, shape=shape, max_abs_err=err, ms=time_ms(kernel, iters=50),
                   plain_ms=time_ms(plain, iters=5, warmup=1), library_ms=time_ms(library, iters=50),
                   bound_ms=bnd, bound_by=by)
        out[f"{name} {shape}"] = row
        log(f"time {label}: kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} bound_ms={bnd:.4f} ({by})  [{card}]")
    return out


def _fleet_run(what: str, make_sched, trace, card: str, signal: str = None, bundle: str = None,
               profile_steps: int = 0, calls: dict = None) -> dict:
    """Serve ``trace`` through a ``FleetRouter`` over two ``LocalReplica``s
    (schedulers from ``make_sched``, warmed up), every request submitted at
    once. ``signal`` ("sigterm" or "sigkill") hits one replica midway: the
    first router step after which one replica holds at least 4 requests in
    flight and the other has at least 2 free slots and nothing queued (a
    slot freed in a tick is refilled from the replica's own queue at the
    next). A SIGTERM migrates
    through ``bundle``; its parts are timed (the export's device-to-host
    copy, ``save_bundle`` with its digests, ``load_bundle`` with its
    verification, ``admit_migrated``'s host-to-device restore), and every
    restored row, codes and scales, is read back from the peer's pool and
    held to the exported bytes bit for bit. The launches of each replica's
    ticks are read around each tick; ``profile_steps`` router steps after
    the signal run under ``torch.profiler`` (the device's idle share). From
    the signal on, K2's and K3's operands go to ``calls``
    (:func:`kernel_operands`)."""
    from deepspeed_tpu_torch.inference.fleet import FleetRouter, LocalReplica
    from deepspeed_tpu_torch.inference.fleet import migrate as migrate_mod
    from deepspeed_tpu_torch.inference.fleet import replica as replica_mod
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches

    router = FleetRouter()
    reps, ticks = [], {}
    parts = {"export": [], "restore": []}
    exported, restored = {}, {"rows": 0, "bytes": 0, "unequal": []}

    def export(sched):
        orig = sched.export_inflight

        def f(release=True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payloads = orig(release=release)
            parts["export"].append(time.perf_counter() - t0)
            exported.update((p["request_id"], p) for p in payloads)
            return payloads
        return f

    def admit(sched):
        orig = sched.admit_migrated

        def f(payload):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            req = orig(payload)
            torch.cuda.synchronize()
            parts["restore"].append(time.perf_counter() - t0)
            if req is not None:
                slot = next(i for i, r in enumerate(sched._slot_req) if r is req)
                caches, n = dict(sched._roles()), payload["length"]
                for role, leaves in exported[payload["request_id"]]["kv"].items():
                    for name, rows in leaves.items():
                        got = caches[role][name][slot, :n].cpu()
                        restored["rows"] += n
                        restored["bytes"] += got.numel() * got.element_size()
                        if not torch.equal(got.view(torch.uint8), rows.contiguous().view(torch.uint8)):
                            restored["unequal"].append((payload["request_id"], role, name))
            return req
        return f

    for i in range(2):
        sched = make_sched()
        sched.warmup()
        sched.export_inflight, sched.admit_migrated = export(sched), admit(sched)
        ticks[f"r{i}"] = []
        sched.step = _read_launches(sched.step, ticks[f"r{i}"])
        reps.append(LocalReplica(f"r{i}", sched))
        router.add_replica(f"r{i}", reps[-1])
    save, load = replica_mod.save_bundle, migrate_mod.load_bundle
    parts["save_bundle"] = _timed_calls(replica_mod, "save_bundle")
    parts["load_bundle"] = _timed_calls(migrate_mod, "load_bundle")
    hit, idle = None, None
    capture = contextlib.ExitStack()
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0, m0 = time.perf_counter(), time.monotonic()
        rids = [router.submit(p, n) for p, n in trace]
        rounds = 0
        while router.pending and rounds < 100000:
            router.step()
            rounds += 1
            if signal is None or hit is not None:
                continue
            for victim, peer in ((reps[0], reps[1]), (reps[1], reps[0])):
                if (len(victim.scheduler.in_flight) >= 4 and len(peer.scheduler._free_slots()) >= 2
                        and not len(peer.scheduler.queue)):
                    hit = dict(victim=victim.name, peer=peer.name, round=rounds,
                               s=time.perf_counter() - t0, in_flight=len(victim.scheduler.in_flight),
                               peer_free_slots=len(peer.scheduler._free_slots()),
                               marks={r.name: len(ticks[r.name]) for r in reps})
                    if calls is not None:
                        capture.enter_context(kernel_operands(calls))
                    if signal == "sigterm":
                        victim.sigterm(bundle)
                    else:
                        victim.sigkill()
                    if profile_steps:
                        idle = _profile_router(router, profile_steps)
                    break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        capture.close()
        replica_mod.save_bundle, migrate_mod.load_bundle = save, load
    counts = launches()
    if signal is not None and hit is None:
        raise AssertionError(f"{what}: no step had a replica with 4 in flight beside a peer with 2 free slots")
    st = router.stats()
    outputs = [router.completed[rid]["output"] if rid in router.completed else None for rid in rids]
    reqs = {}
    for r in reps:
        for req in r.scheduler.finished:
            reqs.setdefault(req.meta.get("fleet_rid"), req)
    migrated = [rid for rid, req in reqs.items() if "migrated_from" in req.meta]
    ttft = {"migrated": [reqs[rid].first_token_time - m0 for rid in migrated],
            "rest": [req.first_token_time - m0 for rid, req in reqs.items() if rid not in migrated]}
    out = dict(wall_s=wall, rounds=rounds, stats=st, launches=counts, signal=signal, hit=hit,
               migrated=len(migrated), generated_tokens=sum(len(o or ()) for o in outputs),
               ttft_from_submit={k: _percentiles_ms(v) for k, v in ttft.items()})
    out["tokens_per_s"] = out["generated_tokens"] / wall
    if hit is not None:
        peer_ticks = ticks[hit["peer"]][hit["marks"][hit["peer"]]:]
        out["peer_ticks_after_signal"] = len(peer_ticks)
        out["peer_launches_after_signal"] = {k: sum(c[k] for c in peer_ticks) for k in FLEET_KERNELS}
    if signal == "sigterm":
        files = [os.path.join(bundle, f) for f in os.listdir(bundle)]
        n_req = sum(f.endswith(".npz") for f in files)
        out["migration"] = dict(
            requests=n_req, bundle_bytes=sum(os.path.getsize(f) for f in files),
            bundle_bytes_per_request=sum(os.path.getsize(f) for f in files) / max(n_req, 1),
            seconds={k: sum(v) for k, v in parts.items()}, calls={k: len(v) for k, v in parts.items()},
            restored_rows=restored["rows"], restored_bytes=restored["bytes"],
            restored_unequal=restored["unequal"])
    if idle is not None:
        out["profile_after_signal"] = idle
        log(f"phase {what}: {idle['steps']} router steps after the signal under the profiler: "
            f"{idle['wall_ms']:.1f} ms wall, device busy {idle['busy_ms']:.1f} ms, idle share "
            f"{idle['idle_share']}  [{card}]")
    log(f"phase {what}: {st['completed']} completed, {st['failed']} failed, "
        f"{st['duplicate_completions']} duplicate, {st['readmitted']} re-admitted, {len(migrated)} migrated, "
        f"{out['generated_tokens']} tokens in {wall:.3f} s ({out['tokens_per_s']:.1f} tokens/s), signal "
        f"{hit}, TTFT from submit {out['ttft_from_submit']}, launches {counts}"
        + (f", migration {out['migration']}" if signal == "sigterm" else "") + f"  [{card}]")
    out["outputs"] = outputs
    return out


def _profile_router(router, steps: int) -> dict:
    """``steps`` router steps under ``torch.profiler``: their wall, the
    device's busy time in them and its idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            router.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
    return dict(steps=steps, wall_ms=wall * 1e3, busy_ms=busy,
                idle_share=(1 - busy / (wall * 1e3)) if busy else None)


def _fleet_checks(what: str, run: dict, n: int, signal: str) -> None:
    st = run["stats"]
    ok = (st["completed"] == n and st["failed"] == 0 and st["duplicate_completions"] == 0
          and st["pending"] == 0)
    if signal == "sigterm":
        mig = run["migration"]
        ok = ok and run["migrated"] >= 1 and mig["restored_rows"] > 0 and not mig["restored_unequal"]
    elif signal == "sigkill":
        ok = ok and st["readmitted"] >= 1
    if signal is not None and "peer_launches_after_signal" in run:
        ok = ok and all(v > 0 for v in run["peer_launches_after_signal"].values())
    RESULTS["checks"].append({"name": f"{what}: accounting", "stats": st, "ok": ok})
    if not ok:
        raise AssertionError(f"{what}: {st}, migrated {run['migrated']}, "
                             f"{run.get('migration')}, peer launches {run.get('peer_launches_after_signal')}")


def fleet_inprocess(seed: int, card: str, rounding: float, work: str):
    """Phase 18 (a): two ``LocalReplica``s of GPT-2 350m (bf16, int8
    weights, int8 KV, the prefix cache on: every ``ServingConfig`` field but
    ``slots`` and ``weight_dtype`` at its default) under one ``FleetRouter``,
    on the phase's trace: against one uninterrupted scheduler, a SIGTERM
    that migrates and a SIGKILL that re-admits (bf16: the margin rule), and
    a SIGTERM in fp32 (token for token).
    Returns (its numbers, its launch counts, the K2 and K3 operands its
    SIGTERM runs gave from the signal on)."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
    from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler, ServingConfig

    out, total, calls = {}, {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    cfg = get_gpt2_config("350m", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    engine = init_inference(GPT2LMHeadModel(cfg, device="cuda", generator=gen), dtype="bf16",
                            kernel_inject=True, use_flash_prefill=True)
    trace = fleet_trace(np.random.default_rng(seed + 18), cfg.vocab_size)
    scfg = ServingConfig(slots=FLEET_SLOTS, weight_dtype="int8")
    sched, reqs, ref_run = _serve_run("18 (a) bf16, one scheduler, uninterrupted", engine, scfg, trace, card)
    add(ref_run["launches"])
    ref = [list(r.output) for r in reqs]
    served = sched.module
    del sched
    runs = {"reference": ref_run}
    for signal in ("sigterm", "sigkill"):
        run = _fleet_run(f"18 (a) bf16 fleet, {signal}", lambda: ContinuousBatchingScheduler(engine, scfg),
                         trace, card, signal=signal, bundle=os.path.join(work, f"bf16_{signal}"),
                         profile_steps=10 if signal == "sigkill" else 0,
                         calls=calls if signal == "sigterm" else None)
        _fleet_checks(f"phase 18 (a) bf16 {signal}", run, len(trace), signal)
        add(run["launches"])
        outputs = run.pop("outputs")
        run["lossless"] = check_lossless(f"phase 18 (a) bf16 fleet {signal} vs one scheduler", served, trace,
                                         ref, outputs, rounding, card)
        run["differing_positions"] = _differing_positions(ref, outputs)
        log(f"phase 18 (a) bf16 {signal}: {run['differing_positions']} of "
            f"{sum(len(r) for r in ref)} positions differ from the uninterrupted run  [{card}]")
        runs[f"bf16_{signal}"] = run
    out["margins"] = margin_share(served, trace, ref, rounding)
    del served
    torch.cuda.empty_cache()

    # fp32: the kernels' fp32 bodies, where no near-tie can flip a token
    engine32 = init_inference(_copy_module(engine.module, torch.device("cuda"), torch.float32),
                              dtype=torch.float32, kernel_inject=True, use_flash_prefill=True)
    del engine
    sched, reqs, ref32 = _serve_run("18 (a) fp32, one scheduler, uninterrupted", engine32, scfg, trace, card)
    add(ref32["launches"])
    ref = [list(r.output) for r in reqs]
    del sched
    run = _fleet_run("18 (a) fp32 fleet, sigterm", lambda: ContinuousBatchingScheduler(engine32, scfg),
                     trace, card, signal="sigterm", bundle=os.path.join(work, "fp32_sigterm"), calls=calls)
    _fleet_checks("phase 18 (a) fp32 sigterm", run, len(trace), "sigterm")
    add(run["launches"])
    outputs = run.pop("outputs")
    same = sum(a == b for a, b in zip(ref, outputs))
    ok = same == len(trace)
    RESULTS["checks"].append({"name": "phase 18 (a) fp32 fleet sigterm vs one scheduler: token-identical",
                              "identical": same, "requests": len(trace), "ok": ok})
    log(f"check phase 18 (a) fp32 fleet with a SIGTERM vs one scheduler: {same}/{len(trace)} requests "
        f"token-identical {'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        raise AssertionError(f"phase 18 (a) fp32: the migration changed the tokens of {len(trace) - same} requests")
    runs["reference_fp32"], runs["fp32_sigterm"] = ref32, run
    out["runs"] = runs
    del engine32
    torch.cuda.empty_cache()
    return out, total, calls


def _wait_all_ready(workers, timeout: float = 600.0) -> dict:
    """Seconds from the spawn to each worker's ``ready`` (engine built,
    kernels loaded, steps warmed up), all waited on together."""
    t0, ready = time.perf_counter(), {}
    while len(ready) < len(workers):
        for w in workers:
            if w.name in ready:
                continue
            try:
                msg = w.wait_ready(timeout=0.05)
            except TimeoutError:
                continue
            ready[w.name] = dict(s=time.perf_counter() - t0, pid=msg["pid"])
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"workers not ready in {timeout} s: ready {ready}")
    return ready


def _serve_over_pipes(router, trace, autoscaler, decisions: list, sigterm: bool = False) -> dict:
    """Submit ``trace`` to ``router``'s subprocess replicas and poll until it
    is done. After each poll that brought tick messages the autoscaler
    decides from the replicas' pipe signals (its ``now``: the host's
    monotonic clock); each decision's inputs go to ``decisions``.
    ``sigterm``: the trace's first 8 requests go out alone, 4 a worker; once
    a worker's signals show its 4 in flight after 5 tick messages of this
    run, it gets one real SIGTERM, and the rest of the trace goes out once
    the peer has admitted the bundle (so the peer has the slots the 4 need)
    and the victim has exited."""
    t0 = time.perf_counter()
    head = trace[:8] if sigterm else trace
    rids = [router.submit(p, n) for p, n in head]
    ticks0 = {n: r.ticks_seen for n, r in router.replicas.items()}
    hit, migrated, rest, admitted = None, [], sigterm, False
    while (router.pending or rest) and time.perf_counter() - t0 < 600:
        msgs = router.poll()
        migrated += [rid for m in msgs if m["type"] == "migrated_in" for rid in m.get("rids") or ()]
        sigs = {n: r.signals() for n, r in router.alive_replicas().items()}
        if any(m["type"] == "tick" for m in msgs) and all(
                s and (s["finished"] or s["in_flight"] or s["queue_depth"]) for s in sigs.values()):
            now = time.monotonic()
            delta = autoscaler.decide(sigs, now=now)
            decisions.append(dict(now=now, signals=sigs, delta=delta, reason=autoscaler.last_reason))
        if sigterm and hit is None:
            for name, rep in router.replicas.items():
                mine = rep.signals() or {}
                if mine.get("in_flight", 0) >= 4 and rep.ticks_seen - ticks0[name] >= 5:
                    hit = dict(victim=name, s=time.perf_counter() - t0, in_flight=mine["in_flight"])
                    rep.sigterm()
                    break
            if hit is None and not router.pending:
                raise AssertionError("phase 18 (b): no worker held 4 in flight after 5 ticks of the run")
        admitted = admitted or any(m["type"] == "migrated_in" for m in msgs)
        victim = router.replicas.get(hit["victim"]) if hit else None  # None: removed, dead
        if rest and admitted and (victim is None or not victim.alive):
            rids += [router.submit(p, n) for p, n in trace[len(head):]]
            rest = False
        time.sleep(0.002)
    wall = time.perf_counter() - t0
    if router.pending or rest:
        raise AssertionError(f"requests still pending after 600 s: {sorted(router.pending)[:8]}")
    return dict(rids=rids, wall_s=wall, hit=hit, migrated=migrated)


def fleet_subprocess(seed: int, card: str, work: str) -> dict:
    """Phase 18 (b) and (c): worker processes (``python -m
    deepspeed_tpu_torch.inference.fleet.worker``) on the one card at
    ``FLEET_WORKER_ENV``, all started at once (their kernels load from the
    build the parent made). One worker serves the trace alone and two
    others serve it together, no signal sent (the fleet's tokens/s, 1
    against 2); then those two serve it again and one gets a real SIGTERM
    mid-flight (:func:`_serve_over_pipes`): it exits 143, and the peer
    verifies and admits its bundle.
    Every run's tokens against an in-process scheduler built from the same
    knobs (the worker's fp32 weights: token for token). (c): the
    autoscaler's decisions, made online from the pipe signals, against
    their replay from the workers' telemetry files."""
    from deepspeed_tpu_torch.inference.fleet import (AutoscalePolicy, Autoscaler, FleetRouter,
                                                     SubprocessReplica)
    from deepspeed_tpu_torch.inference.fleet.worker import build_scheduler
    from deepspeed_tpu_torch.inference.serving import FINISHED, Request, iter_serve_events
    from deepspeed_tpu_torch.ops.cuda import launches, reset_launches
    from deepspeed_tpu_torch.runtime.telemetry import TELEMETRY_FILE

    from deepspeed_tpu_torch import get_gpt2_config

    env = dict(FLEET_WORKER_ENV)
    vocab = get_gpt2_config(env["FLEET_MODEL"]).vocab_size
    trace = fleet_trace(np.random.default_rng(seed + 18), vocab)  # (a)'s trace
    out = {}
    # the in-process reference from the worker's own construction
    sched, _ = build_scheduler(env)
    reqs = [Request(p, max_new_tokens=n) for p, n in trace]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rc = sched.serve(reqs)
    torch.cuda.synchronize()
    counts = launches()
    ref = [list(r.output) for r in reqs]
    if rc != 0 or not all(r.state == FINISHED for r in reqs):
        raise AssertionError("phase 18 (b): the in-process reference did not finish every request")
    out["reference"] = dict(wall_s=time.perf_counter() - t0, launches=counts,
                            tokens_per_s=sum(map(len, ref)) / (time.perf_counter() - t0))
    del sched
    torch.cuda.empty_cache()
    tdir = os.path.join(work, "telemetry")
    workers = [SubprocessReplica(f"w{i}", os.path.join(work, f"w{i}"),
                                 env=dict(env, FLEET_TELEMETRY_DIR=tdir, FLEET_NAME=f"w{i}"))
               for i in range(3)]
    online = Autoscaler(AutoscalePolicy())
    decisions: list = []
    try:
        out["ready"] = _wait_all_ready(workers)
        log(f"phase 18 (b) workers from process start to ready: {out['ready']}  [{card}]")
        runs = {}
        for label, members, term in (("1 worker", workers[:1], False), ("2 workers", workers[1:], False),
                                     ("2 workers, SIGTERM", workers[1:], True)):
            router = FleetRouter(heartbeat_timeout=120.0)
            for w in members:
                router.add_replica(w.name, w)
            got = _serve_over_pipes(router, trace, online, decisions, sigterm=term)
            st = router.stats()
            outputs = [router.completed[rid]["output"] for rid in got["rids"]]
            same = sum(a == b for a, b in zip(ref, outputs))
            stats = [router.completed[rid]["stats"] for rid in got["rids"]]
            run = dict(wall_s=got["wall_s"], stats=st, identical=same, hit=got["hit"],
                       tokens_per_s=sum(map(len, outputs)) / got["wall_s"])
            if term:
                victim = next(w for w in members if w.name == got["hit"]["victim"])
                run["exit_code"] = victim.wait(60.0)
                bundle = victim.bundle_dir
                files = [os.path.join(bundle, f) for f in os.listdir(bundle)] if os.path.isdir(bundle) else []
                n_req = sum(f.endswith(".npz") for f in files)
                run["bundle_requests"] = n_req
                run["bundle_bytes_per_request"] = sum(os.path.getsize(f) for f in files) / max(n_req, 1)
                run["migrated"] = len(got["migrated"])
            moved = set(got["migrated"])
            run["ttft_from_worker_arrival"] = {
                group: _percentiles_ms([s["ttft"] for rid, s in zip(got["rids"], stats)
                                        if s.get("ttft") is not None and (rid in moved) == (group == "migrated")])
                for group in ("migrated", "rest")}
            ok = (st["completed"] == len(trace) and st["failed"] == 0 and st["duplicate_completions"] == 0
                  and same == len(trace))
            if term:
                ok = ok and run["exit_code"] == 143 and got["hit"] is not None and n_req >= 1 \
                    and run["migrated"] >= 1
            RESULTS["checks"].append({"name": f"phase 18 (b) {label}", "stats": st, "identical": same,
                                      "ok": ok})
            log(f"phase 18 (b) {label}: {st['completed']} completed, {st['failed']} failed, "
                f"{st['duplicate_completions']} duplicate, {st['readmitted']} re-admitted, {same}/{len(trace)} "
                f"token-identical to the in-process run, {sum(map(len, outputs))} tokens in "
                f"{got['wall_s']:.3f} s ({run['tokens_per_s']:.1f} tokens/s), TTFT from the worker's "
                f"arrival {run['ttft_from_worker_arrival']}"
                + (f", SIGTERM at {got['hit']}, exit {run['exit_code']}, bundle of {n_req} requests "
                   f"({run['bundle_bytes_per_request']:.0f} bytes a request), {run['migrated']} admitted by "
                   f"the peer" if term else "")
                + f" {'ok' if ok else 'FAIL'}  [{card}]")
            if not ok:
                raise AssertionError(f"phase 18 (b) {label}: {run}")
            runs[label] = run
        out["runs"] = runs
        out["tokens_per_s_2_over_1"] = runs["2 workers"]["tokens_per_s"] / runs["1 worker"]["tokens_per_s"]
        survivors = [w for w in workers if w.alive]
        t_idle = time.perf_counter()
        while time.perf_counter() - t_idle < 1.0:  # idle ticks carry each survivor's last state
            for w in survivors:
                w.poll()
            time.sleep(0.05)
        final_pipe = {w.name: w.signals() for w in survivors}
    finally:
        for w in workers:
            w.close()
    # (c) the online decisions against their replay from the telemetry files
    files = {w.name: os.path.join(tdir, w.name, TELEMETRY_FILE) for w in workers}
    events = {n: [e for e in iter_serve_events(p, kinds=("serve_tick",))] for n, p in files.items()}
    replay = Autoscaler(AutoscalePolicy())
    unmatched, replayed = 0, []
    for d in decisions:
        sigs = {}
        for n, s in d["signals"].items():
            key = tuple(s.get(k) for k in STATE_KEYS)
            match = next((e for e in events[n] if tuple(e.get(k) for k in STATE_KEYS) == key), None)
            unmatched += match is None
            sigs[n] = match
        replayed.append((replay.decide(sigs, now=d["now"]), replay.last_reason))
    online_list = [(d["delta"], d["reason"]) for d in decisions]
    final = Autoscaler.signals_from_telemetry({n: files[n] for n in final_pipe})
    final_states = {n: {"pipe": {k: (final_pipe[n] or {}).get(k) for k in STATE_KEYS},
                        "telemetry": {k: (final[n] or {}).get(k) for k in STATE_KEYS}} for n in final}
    final_same = all(v["pipe"] == v["telemetry"] for v in final_states.values())
    ok = unmatched == 0 and replayed == online_list and bool(decisions) and final_same
    out["autoscaler"] = dict(decisions=len(decisions), unmatched=unmatched,
                             deltas={str(k): sum(1 for d in decisions if d["delta"] == k) for k in (-1, 0, 1)},
                             reasons=sorted({d["reason"] for d in decisions}), final_signals_equal=final_same,
                             final_states=final_states, ok=ok)
    RESULTS["checks"].append({"name": "phase 18 (c) autoscaler: online decisions = replay from telemetry",
                              "decisions": len(decisions), "unmatched": unmatched, "ok": ok})
    log(f"check phase 18 (c) autoscaler: {len(decisions)} online decisions from the pipe signals "
        f"(+1 {out['autoscaler']['deltas']['1']}, 0 {out['autoscaler']['deltas']['0']}, -1 "
        f"{out['autoscaler']['deltas']['-1']}), replayed from the workers' telemetry files: "
        f"{'equal' if replayed == online_list else 'DIFFERENT'}, {unmatched} states unmatched; the last "
        f"serve_tick of each surviving worker equal to its last pipe signals: {final_same} "
        f"{'ok' if ok else 'FAIL'}  [{card}]")
    if not ok:
        raise AssertionError(f"phase 18 (c): the replay differs: {out['autoscaler']}")
    return out


def fleet_phase(seed: int, card: str, rounding: float):
    """Phase 18 (module docstring): (a) in process, (b) worker processes,
    (c) the autoscaler, then K2 and K3 held against their plain versions on
    the operands (a)'s SIGTERM runs gave them after the signal. Returns (its numbers, the launch
    counts of its runs summed)."""
    work = tempfile.mkdtemp(prefix="phase18_")
    try:
        t0 = time.perf_counter()
        out, total, calls = fleet_inprocess(seed, card, rounding, work)
        out["a_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["b_subprocess"] = fleet_subprocess(seed, card, work)
        out["b_s"] = time.perf_counter() - t0
        for k, v in out["b_subprocess"]["reference"]["launches"].items():
            total[k] = total.get(k, 0) + v
        out["kernel_times"] = check_kernel_operands(calls, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out, total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="all",
                    help="'all' (the default: every phase and the kernels line), or a comma list of "
                         "'times' (K2's and K3's value-form timings alone) and 'serving' (phase 4), "
                         "which use only the API earlier commits share, so that copied into an "
                         "earlier checkout this script measures that commit the same way, "
                         "'kernels' (phase 3 at head dim 64), 'defaults' (phase 14, after "
                         "phase 4, whose measured rounding it reads), 'resilience' (phase 15), "
                         "'moe' (phase 16) and 'rlhf' (phase 17)")
    ap.add_argument("--child", choices=("preempt", "resume", "agent", "torn"),
                    help="run as one of phase 15's training processes (the phase starts them)")
    ap.add_argument("--dir", help="--child: the checkpoint dir")
    ap.add_argument("--out", help="--child: the file of its JSON records")
    ap.add_argument("--steps", type=int, help="--child: train until this step")
    args = ap.parse_args(argv)
    if args.child:
        return child_main(args)
    phases = set(args.phases.split(","))
    if (not phases <= {"all", "times", "serving", "kernels", "defaults", "resilience", "moe", "rlhf",
                       "fleet"}
            or ("all" in phases and len(phases) > 1)):
        ap.error(f"--phases takes 'all' or a comma list of 'times', 'serving', 'kernels', "
                 f"'defaults', 'resilience', 'moe', 'rlhf' and 'fleet', got {args.phases!r}")
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
        if "kernels" in phases:
            kernel_phase(torch.Generator(device="cuda").manual_seed(args.seed), args.seed)
        if phases & {"serving", "defaults", "fleet"}:
            RESULTS["slice"] = slice_phase(args.seed, card)[0]
        if "defaults" in phases:
            RESULTS["defaults"] = defaults_phase(args.seed, card, measured_rounding(RESULTS["slice"]))[0]
        if "resilience" in phases:
            t_phase = time.perf_counter()
            RESULTS["resilience"] = resilience_phase(args.seed, card)[0]
            RESULTS.setdefault("phase_s", {})["15 resilience"] = time.perf_counter() - t_phase
        if "moe" in phases:
            t_phase = time.perf_counter()
            RESULTS["moe"] = moe_phase(args.seed, card)[0]
            RESULTS.setdefault("phase_s", {})["16 MoE serving and Mixtral"] = time.perf_counter() - t_phase
        if "rlhf" in phases:
            t_phase = time.perf_counter()
            RESULTS["rlhf"] = rlhf_phase(args.seed, card)[0]
            RESULTS.setdefault("phase_s", {})["17 RLHF and the inference engine"] = time.perf_counter() - t_phase
        if "fleet" in phases:
            t_phase = time.perf_counter()
            RESULTS["fleet"] = fleet_phase(args.seed, card, measured_rounding(RESULTS["slice"]))[0]
            RESULTS.setdefault("phase_s", {})["18 the serving fleet"] = time.perf_counter() - t_phase
    else:
        phase_s = {}
        t_phase = time.perf_counter()
        lines = kernel_phase(torch.Generator(device="cuda").manual_seed(args.seed), args.seed)
        lines_d128 = kernel_phase_d128(torch.Generator(device="cuda").manual_seed(args.seed + 100), args.seed)
        # phase 16's K5 shapes and phase 17's K2 and K3 shapes, timed here:
        # late in a long process the profiler has come back empty three
        # times running
        k5_16 = k5_routed_times(torch.Generator(device="cuda").manual_seed(args.seed + 12))
        times_17 = rlhf_kernel_times(torch.Generator(device="cuda").manual_seed(args.seed + 10))
        phase_s["3 kernels"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        RESULTS["slice"], serve_counts = slice_phase(args.seed, card)
        phase_s["4 serving"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        RESULTS["defaults"], defaults_counts = defaults_phase(args.seed, card,
                                                              measured_rounding(RESULTS["slice"]))
        phase_s["14 serving at the JAX defaults"] = time.perf_counter() - t_phase
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
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        RESULTS["resilience"], resilience_counts = resilience_phase(args.seed, card)
        phase_s["15 resilience"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        RESULTS["moe"], moe_serve_counts = moe_phase(args.seed, card, k5_16)
        phase_s["16 MoE serving and Mixtral"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        RESULTS["rlhf"], rlhf_counts = rlhf_phase(args.seed, card, times_17)
        phase_s["17 RLHF and the inference engine"] = time.perf_counter() - t_phase
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        RESULTS["fleet"], fleet_counts = fleet_phase(args.seed, card, measured_rounding(RESULTS["slice"]))
        phase_s["18 the serving fleet"] = time.perf_counter() - t_phase
        RESULTS["phase_s"] = phase_s
        log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    RESULTS["total_s"] = time.perf_counter() - t_start
    tag_event_times(RESULTS)
    if "all" in phases:
        tag_event_times({"lines": lines, "lines_d128": lines_d128})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"chip_smoke_seed{args.seed}.json"), "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)
    if "all" in phases:
        # launches: the serving, training, MoE training, sparse attention,
        # engine API, LLaMA training, LLaMA serving, default-serving and
        # resilience paths' counts, each zeroed just before its path and
        # read just after. K1, K4 and K3 also carry their head-dim-128 entry (the
        # LLaMA shapes), with the launches of the LLaMA paths, which run at
        # head dim 128 only; K2 and K3 their speculation verify block entry
        # (phase 14 (b): M = 40, Lq = 5), with its launches per round as
        # the rounds of phase 14 (b) read them around each step's calls.
        paths = (serve_counts, train_counts, moe_counts, sparse_counts, api_counts,
                 llama_train_counts, llama_serve_counts, defaults_counts, resilience_counts,
                 moe_serve_counts, rlhf_counts, fleet_counts)
        b_runs = RESULTS["defaults"]["b_spec"]["runs"]
        student, full = b_runs["on"]["launches_per_round"], b_runs["on_full_depth"]["launches_per_round"]
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
            if "verify_block" in lines[name]:
                block = lines[name]["verify_block"]
                blocks = block.values() if name == "quant_matmul" else [block]
                entry["at_verify_block"] = dict(
                    shapes=[{k: v for k, v in b.items() if k in KERNEL_LINE_KEYS + ("shape",)} for b in blocks],
                    launches_per_round={
                        "target verify": student["target verify"][name],
                        f"drafter decode x{SPEC_K} (4-layer student)": student["drafter decode"][name],
                        "drafter refeed (24-layer drafter run)": full["drafter refeed"][name]})
            if name == "moe_permute":
                # phase 16: the MoE serving tick and the Mixtral step, their
                # launches as the tick probe and the training phase read them
                moe = RESULTS["moe"]
                entry["at_phase16"] = dict(
                    shapes=[dict({k: v for k, v in t.items() if k in KERNEL_LINE_KEYS + ("shape",)},
                                 name="moe_permute") for t in moe["k5"].values()],
                    launches=moe_serve_counts.get(name, 0),
                    launches_per_decode_tick=moe["a_moe_scheduler"]["ticks"]["decode"]["launches_per_tick"][name],
                    launches_per_mixtral_step=moe["c_mixtral_training"]["launches_per_step"][name])
            if name in ("quant_matmul", "flash_decode"):
                # phase 17: K2 at the rollout's prefill tick, K3 at the beam
                # step; launches as phase 17's paths read them
                times = RESULTS["rlhf"]["kernel_times"][name]
                entry["at_phase17"] = dict(
                    shapes=[dict({k: v for k, v in t.items() if k in KERNEL_LINE_KEYS + ("shape",)},
                                 key=key) for key, t in times.items()],
                    launches=rlhf_counts.get(name, 0))
                # phase 18: the shapes the fleet's runs gave K2 and K3 (bf16
                # and fp32), and the launches of its runs
                entry["at_phase18"] = dict(
                    shapes=[{k: v for k, v in t.items() if k in KERNEL_LINE_KEYS + ("shape",)}
                            for t in RESULTS["fleet"]["kernel_times"].values() if t["name"] == name],
                    launches=fleet_counts.get(name, 0))
            kernels.append(entry)
        log(json.dumps({"kernels": kernels}))
    log(f"total {RESULTS['total_s']:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
