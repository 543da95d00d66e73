"""A fleet replica worker (counterpart of
``deepspeed_tpu/inference/fleet/worker.py``)::

    python -m deepspeed_tpu_torch.inference.fleet.worker

One serving process of the fleet: it builds an engine and a
continuous-batching scheduler, then loops: requests in as line-delimited
JSON on stdin, ``done`` and ``tick`` out on stdout (``protocol.py``), logs
on stderr, liveness through the heartbeat file the scheduler touches every
tick.

SIGTERM is the migrate path: refuse the queue (``refused`` messages the
router re-dispatches), export every in-flight request's KV through the
digest-verified bundle (``migrate.py``), announce ``migrated_out``, exit 143.
A ``MigrationError`` (sampling on, a failed save) falls back to the drain:
finish the in-flight requests here, then exit 143. SIGKILL gets no say: the
router's heartbeat probe and its at-most-once re-admission recover from it.

The weights are GPT-2's at ``FLEET_MODEL``'s width, drawn from the fixed
seed ``WEIGHT_SEED``, so every replica holds the same ones. The engine is
built with kernel injection and the flash backend, so its decode and
prefill attention run K3 on the card.

Env (set by :class:`SubprocessReplica` or its caller; the JAX package's
knobs and defaults, and ``FLEET_DEVICE``):
  FLEET_MODEL=test        GPT-2 config name
  FLEET_SLOTS=4           decode slots
  FLEET_CHUNK=16          prefill chunk
  FLEET_POSITIONS=128     context length
  FLEET_KV_QUANT=1        int8 KV pools
  FLEET_PREFIX_CACHE=     on|off: content-hashed KV prefix caching (unset:
                          ``ServingConfig``'s default, on)
  FLEET_POOL_TOKENS=0     KV pool token budget (0: slots x context)
  FLEET_TICK_SLEEP_MS=0   sleep after each tick (emulates a device-bound
                          tick on a host that has no device to wait for)
  FLEET_BUNDLE_DIR=...    where a SIGTERM lands the migration bundle
  FLEET_TELEMETRY_DIR=... telemetry run dir (``serve_tick`` etc.); unset: off
  FLEET_NAME=...          replica name (the telemetry job name)
  FLEET_DEVICE=cuda       the card; ``cpu`` runs the plain versions on the
                          CPU, as the entry points' ``device="cpu"`` does
  DS_ELASTIC_HEARTBEAT_FILE=...  liveness file (the parent's)
"""

import os
import select
import sys
import tempfile
import time
from typing import Mapping, Optional

import numpy as np
import torch

#: the seed every replica draws its weights from
WEIGHT_SEED = 0


def build_scheduler(env: Optional[Mapping[str, str]] = None):
    """The worker's engine and scheduler from ``env``'s ``FLEET_*`` knobs
    (``os.environ`` by default), warmed up; returns ``(scheduler,
    telemetry or None)``. A caller in another process gets the same weights
    and steps from the same knobs."""
    from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
    from deepspeed_tpu_torch.device import resolve_device
    from deepspeed_tpu_torch.inference.serving import (ContinuousBatchingScheduler,
                                                       ServingConfig)

    env = os.environ if env is None else env
    device = resolve_device(env.get("FLEET_DEVICE", "cuda"))
    model = env.get("FLEET_MODEL", "test")
    positions = int(env.get("FLEET_POSITIONS", "128"))
    cfg = get_gpt2_config(model, n_positions=positions)
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    engine = init_inference(GPT2LMHeadModel(cfg, device=device, generator=gen), device=device,
                            kernel_inject=True, use_flash_prefill=True, max_out_tokens=positions)
    telemetry = None
    tdir = env.get("FLEET_TELEMETRY_DIR")
    if tdir:
        from deepspeed_tpu_torch.runtime.telemetry import RuntimeTelemetry, TelemetryConfig
        telemetry = RuntimeTelemetry(TelemetryConfig(
            enabled=True, output_path=tdir,
            job_name=env.get("FLEET_NAME", f"replica_{os.getpid()}")))
    scfg = ServingConfig(
        slots=int(env.get("FLEET_SLOTS", "4")),
        prefill_chunk=int(env.get("FLEET_CHUNK", "16")),
        kv_quant=env.get("FLEET_KV_QUANT", "1") == "1",
        kv_pool_tokens=int(env.get("FLEET_POOL_TOKENS", "0")) or None,
        prefix_cache=env.get("FLEET_PREFIX_CACHE") or None)
    sched = ContinuousBatchingScheduler(engine, scfg, telemetry=telemetry)
    if telemetry is not None:
        telemetry.write_run_header(
            {"bench": "fleet_worker", "model": model, "pid": os.getpid(),
             "backend": device.type, "scope": "serve_decode",
             "prefix_cache": sched.prefix_cache, "cached_prefix_tokens": 0})
    sched.warmup()
    return sched, telemetry


def main() -> int:
    from deepspeed_tpu_torch.inference.fleet import protocol
    from deepspeed_tpu_torch.inference.fleet.migrate import (bundle_rids, receive_bundle,
                                                             save_bundle)
    from deepspeed_tpu_torch.inference.serving import MigrationError, Request
    from deepspeed_tpu_torch.runtime.resilience.signals import (DEFAULT_PREEMPT_EXIT_CODE,
                                                                PreemptionGuard)

    out = sys.stdout
    guard = PreemptionGuard().install()
    sched, telemetry = build_scheduler()
    protocol.send(out, {"type": "ready", "pid": os.getpid(), "slots": sched.slots,
                        "capacity": sched.capacity})

    stdin_fd = sys.stdin.fileno()
    os.set_blocking(stdin_fd, False)
    buf = b""
    fin_idx = 0
    stopping = False
    tick = 0
    last_idle_tick = 0.0
    last_busy_tick = 0.0
    tick_sleep = float(os.environ.get("FLEET_TICK_SLEEP_MS", "0")) / 1e3

    def drain_finished():
        nonlocal fin_idx
        while fin_idx < len(sched.finished):
            req = sched.finished[fin_idx]
            fin_idx += 1
            protocol.send(out, {"type": "done", "rid": req.meta.get("fleet_rid"),
                                "output": list(req.output), "stats": req.stats()})

    def read_msgs():
        nonlocal buf
        msgs = []
        while True:
            try:
                ready, _, _ = select.select([stdin_fd], [], [], 0)
            except (OSError, ValueError):
                return msgs, True
            if not ready:
                return msgs, False
            try:
                chunk = os.read(stdin_fd, 65536)
            except (BlockingIOError, OSError):
                return msgs, False
            if not chunk:  # the router hung up
                return msgs, True
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                msg = protocol.parse_line(line.decode("utf-8", "replace"))
                if msg is not None:
                    msgs.append(msg)

    while True:
        if guard.requested:
            signal_name = guard.consume()
            refused = sched.queue.refuse_all(f"draining on {signal_name}")
            for req in refused:
                protocol.send(out, {"type": "refused", "rid": req.meta.get("fleet_rid"),
                                    "reason": req.refuse_reason})
            if telemetry is not None:
                telemetry.emit("serve_drain", signal=signal_name,
                               in_flight=len(sched.in_flight), refused=len(refused))
            if sched.in_flight:
                bundle_dir = os.environ.get("FLEET_BUNDLE_DIR") or os.path.join(
                    tempfile.gettempdir(), f"fleet_bundle_{os.getpid()}")
                try:
                    payloads = sched.export_inflight(release=False)
                    save_bundle(payloads, bundle_dir)
                    sched.release_inflight()
                    protocol.send(out, {"type": "migrated_out", "bundle": bundle_dir,
                                        "rids": bundle_rids(payloads)})
                    if telemetry is not None:
                        telemetry.emit("serve_migrate_out", signal=signal_name,
                                       migrated=len(payloads), bundle=bundle_dir)
                except MigrationError as e:
                    print(f"fleet worker: migration refused ({e}); draining",
                          file=sys.stderr, flush=True)
                    sched.run_until_drained(admit=False)
                    drain_finished()
            protocol.send(out, {"type": "bye", "exit": DEFAULT_PREEMPT_EXIT_CODE})
            if telemetry is not None:
                telemetry.close()
            return DEFAULT_PREEMPT_EXIT_CODE

        msgs, eof = read_msgs()
        for msg in msgs:
            kind = msg["type"]
            if kind == "request":
                req = Request(prompt=np.asarray(msg["prompt"], np.int32),
                              max_new_tokens=msg["max_new_tokens"],
                              eos_token_id=msg.get("eos_token_id"))
                req.meta["fleet_rid"] = msg["rid"]
                sched.submit(req)
                if req.state == "refused":
                    protocol.send(out, {"type": "refused", "rid": msg["rid"],
                                        "reason": req.refuse_reason})
            elif kind == "migrate_in":
                try:
                    admitted, refused_p = receive_bundle(sched, msg["bundle"])
                    protocol.send(out, {"type": "migrated_in",
                                        "rids": [r.meta.get("fleet_rid") for r in admitted],
                                        "refused_rids": bundle_rids(refused_p)})
                except MigrationError as e:
                    print(f"fleet worker: bundle refused ({e})", file=sys.stderr, flush=True)
                    protocol.send(out, {"type": "migrated_in", "rids": [], "refused_rids": [],
                                        "error": str(e)})
            elif kind == "stop":
                stopping = True

        if sched.in_flight or len(sched.queue):
            sched.step()
            if tick_sleep:
                time.sleep(tick_sleep)
            tick += 1
            drain_finished()
            # the load signals go out at a cadence, not every step: they
            # change little from one step to the next, and each line is one
            # the router must parse
            now = time.monotonic()
            if now - last_busy_tick > 0.05:
                last_busy_tick = now
                protocol.send(out, {"type": "tick", "signals": sched.signals()})
        elif stopping or eof:
            protocol.send(out, {"type": "bye", "exit": 0})
            if telemetry is not None:
                telemetry.close()
            return 0
        else:
            # idle: stay alive (the heartbeat) and wait for work without
            # spinning a core; a tick message at a cadence keeps the
            # router's view of the load fresh
            sched._touch_serving_heartbeat(tick)
            now = time.monotonic()
            if now - last_idle_tick > 0.2:
                last_idle_tick = now
                protocol.send(out, {"type": "tick", "signals": sched.signals()})
            try:
                select.select([stdin_fd], [], [], 0.02)
            except (OSError, ValueError):
                pass


if __name__ == "__main__":
    sys.exit(main())
