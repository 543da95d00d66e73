"""Replica handles: one object per serving process the router dispatches to
(counterpart of ``deepspeed_tpu/inference/fleet/replica.py``).

Two implementations of one small duck-typed surface (``send`` / ``poll`` /
``alive`` / ``load``):

* :class:`LocalReplica` wraps a ``ContinuousBatchingScheduler`` in
  process. No pipes, no sleeps: tests drive several of these (sharing one
  engine) under a simulated clock, and ``sigterm`` / ``sigkill`` are method
  calls that replay the paths the subprocess worker takes on real signals
  (migrate, else drain; hard death).
* :class:`SubprocessReplica` spawns ``python -m
  deepspeed_tpu_torch.inference.fleet.worker`` speaking the line-delimited
  JSON protocol over pipes, its stderr to a log file, its liveness from
  the heartbeat file (``elasticity.heartbeat_age``) and the exit code.

The router never cares which it holds.
"""

import logging
import os
import select
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.elasticity.elastic_agent import HEARTBEAT_ENV, heartbeat_age
from deepspeed_tpu_torch.inference.fleet import protocol
from deepspeed_tpu_torch.inference.fleet.migrate import bundle_rids, receive_bundle, save_bundle
from deepspeed_tpu_torch.inference.serving.request import REFUSED, Request
from deepspeed_tpu_torch.inference.serving.scheduler import MigrationError

logger = logging.getLogger(__name__)


class LocalReplica:
    """In-process replica: a scheduler and an outbox of protocol messages.

    ``pump()`` advances the scheduler, the stand-in for the worker's main
    loop; the router calls it from ``step()``. Signals are method calls, so
    the migrate and re-admit paths are tested without subprocesses."""

    def __init__(self, name: str, scheduler):
        self.name = name
        self.scheduler = scheduler
        self.dead = False
        self.exit_code: Optional[int] = None
        self._out: List[dict] = []
        self._fin_idx = 0  # scheduler.finished watermark -> done messages
        self._out.append({"type": "ready", "pid": os.getpid(), "slots": scheduler.slots,
                          "capacity": scheduler.capacity})

    # -- router-facing surface -----------------------------------------
    @property
    def alive(self) -> bool:
        return not self.dead

    def load(self) -> float:
        """Dispatch score: outstanding work (queued and in flight). A dead
        replica never wins."""
        if self.dead:
            return float("inf")
        s = self.scheduler
        return len(s.queue) + len(s.in_flight)

    def signals(self) -> Optional[Dict]:
        return None if self.dead else self.scheduler.signals()

    def send(self, msg: dict) -> None:
        if self.dead:
            raise RuntimeError(f"replica {self.name} is dead")
        kind = msg["type"]
        if kind == "request":
            req = Request(prompt=np.asarray(msg["prompt"], np.int32),
                          max_new_tokens=msg["max_new_tokens"], eos_token_id=msg.get("eos_token_id"))
            req.meta["fleet_rid"] = msg["rid"]
            self.scheduler.submit(req)
            if req.state == REFUSED:
                self._out.append({"type": "refused", "rid": msg["rid"], "reason": req.refuse_reason})
        elif kind == "migrate_in":
            admitted, refused = receive_bundle(self.scheduler, msg["bundle"])
            self._out.append({"type": "migrated_in",
                              "rids": [r.meta.get("fleet_rid") for r in admitted],
                              "refused_rids": bundle_rids(refused)})
        elif kind == "stop":
            self.dead = True
            self.exit_code = 0
            self._out.append({"type": "bye", "exit": 0})
        else:
            raise ValueError(f"unknown router->replica message {kind!r}")

    def poll(self) -> List[dict]:
        out, self._out = self._out, []
        return out

    # -- progress ------------------------------------------------------
    def pump(self, max_ticks: int = 1) -> None:
        """Advance the scheduler up to ``max_ticks`` non-idle ticks, turn the
        newly finished requests into ``done`` messages and add one ``tick``
        message (the pipe's twin of ``serve_tick``)."""
        if self.dead:
            return
        s = self.scheduler
        for _ in range(max_ticks):
            if not (s.in_flight or len(s.queue)):
                break
            s.step()
        self._drain_finished()
        self._out.append({"type": "tick", "signals": s.signals()})

    def _drain_finished(self) -> None:
        s = self.scheduler
        while self._fin_idx < len(s.finished):
            req = s.finished[self._fin_idx]
            self._fin_idx += 1
            self._out.append({"type": "done", "rid": req.meta.get("fleet_rid"),
                              "output": list(req.output), "stats": req.stats()})

    # -- simulated signals ---------------------------------------------
    def sigterm(self, bundle_dir: str) -> None:
        """The worker's SIGTERM path in process: refuse the queue, migrate
        the in-flight requests through a bundle, and drain (finish them
        here) on :class:`MigrationError`."""
        s = self.scheduler
        for req in s.queue.refuse_all("draining on SIGTERM"):
            self._out.append({"type": "refused", "rid": req.meta.get("fleet_rid"),
                              "reason": req.refuse_reason})
        if s.in_flight:
            try:
                payloads = s.export_inflight(release=False)
                save_bundle(payloads, bundle_dir)
                s.release_inflight()
                self._out.append({"type": "migrated_out", "bundle": bundle_dir,
                                  "rids": bundle_rids(payloads)})
            except MigrationError as e:
                logger.info(f"fleet: {self.name} migration refused ({e}); draining")
                s.run_until_drained(admit=False)
                self._drain_finished()
        self.dead = True
        self.exit_code = 143

    def sigkill(self) -> None:
        """Hard death: no drain, no messages; the queued and in-flight work
        is gone, and the router's liveness sweep must recover it."""
        self.dead = True
        self.exit_code = -signal.SIGKILL


class SubprocessReplica:
    """One ``fleet/worker.py`` child on pipes.

    ``env`` overlays the parent's environment (the ``FLEET_*`` knobs); the
    replica's heartbeat file and stderr log go under ``workdir``. Liveness
    is the exit code or a stale heartbeat: a replica wedged inside a step
    never exits, so the router also compares ``heartbeat_age()`` with its
    timeout."""

    def __init__(self, name: str, workdir: str, env: Optional[Dict[str, str]] = None,
                 bundle_dir: Optional[str] = None):
        self.name = name
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.heartbeat_path = os.path.join(workdir, f"{name}.heartbeat")
        self.stderr_path = os.path.join(workdir, f"{name}.stderr")
        self.bundle_dir = bundle_dir or os.path.join(workdir, f"{name}.bundle")
        child_env = dict(os.environ)
        child_env.update(env or {})
        child_env[HEARTBEAT_ENV] = self.heartbeat_path
        child_env["FLEET_BUNDLE_DIR"] = self.bundle_dir
        self._stderr_fh = open(self.stderr_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.inference.fleet.worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self._stderr_fh,
            env=child_env, text=False)
        os.set_blocking(self.proc.stdout.fileno(), False)
        self._buf = b""
        self._pending: List[dict] = []  # messages seen before 'ready'
        self._last_signals: Optional[Dict] = None
        self.ticks_seen = 0  # tick messages received
        # requests sent since the last tick: a burst of submits between ticks
        # must not all price this replica at its stale load, or least-loaded
        # dispatch piles the whole burst onto one worker
        self._sent_since_tick = 0

    # -- router-facing surface -----------------------------------------
    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    @property
    def exit_code(self) -> Optional[int]:
        return self.proc.poll()

    def heartbeat_age(self) -> Optional[float]:
        return heartbeat_age(self.heartbeat_path)

    def load(self) -> float:
        if not self.alive:
            return float("inf")
        if self._last_signals is None:
            return float(self._sent_since_tick)  # a fresh replica: the sends alone
        return (self._last_signals.get("queue_depth", 0) + self._last_signals.get("in_flight", 0)
                + self._sent_since_tick)

    def signals(self) -> Optional[Dict]:
        return self._last_signals

    def send(self, msg: dict) -> None:
        if not self.alive:
            raise RuntimeError(f"replica {self.name} is dead")
        self.proc.stdin.write(protocol.encode(msg).encode())
        self.proc.stdin.flush()
        if msg.get("type") == "request":
            self._sent_since_tick += 1

    def poll(self) -> List[dict]:
        """Drain what the child has written without blocking; a half line
        stays buffered until its newline arrives."""
        fd = self.proc.stdout.fileno()
        while True:
            try:
                ready, _, _ = select.select([fd], [], [], 0)
            except (OSError, ValueError):
                break
            if not ready:
                break
            try:
                chunk = os.read(fd, 65536)
            except (BlockingIOError, OSError):
                break
            if not chunk:
                break
            self._buf += chunk
        msgs: List[dict] = self._pending
        self._pending = []
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            msg = protocol.parse_line(line.decode("utf-8", "replace"))
            if msg is not None:
                if msg["type"] == "tick":
                    self._last_signals = msg.get("signals")
                    self._sent_since_tick = 0
                    self.ticks_seen += 1
                msgs.append(msg)
        return msgs

    def wait_ready(self, timeout: float = 300.0) -> dict:
        """Block until the child's ``ready`` handshake (engine built, kernels
        loaded, steps warmed up) or raise, so that no build is timed inside
        a serving window."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            batch = self.poll()
            for i, msg in enumerate(batch):
                if msg["type"] == "ready":
                    self._pending.extend(batch[i + 1:])  # later messages stay queued
                    return msg
                self._pending.append(msg)
            if not self.alive:
                raise RuntimeError(f"replica {self.name} died before ready (exit "
                                   f"{self.exit_code}); stderr: {self.stderr_path}")
            time.sleep(0.05)
        raise TimeoutError(f"replica {self.name} not ready in {timeout}s")

    # -- signals -------------------------------------------------------
    def sigterm(self) -> None:
        if self.alive:
            self.proc.send_signal(signal.SIGTERM)

    def sigkill(self) -> None:
        if self.alive:
            self.proc.kill()

    def wait(self, timeout: float = 60.0) -> Optional[int]:
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def close(self) -> None:
        if self.alive:
            try:
                self.send({"type": "stop"})
            except (OSError, RuntimeError, ValueError):
                pass
            if self.wait(10.0) is None:
                self.proc.kill()
                self.proc.wait()
        for fh in (self.proc.stdin, self.proc.stdout):
            try:
                fh.close()
            except OSError:
                pass
        self._stderr_fh.close()
