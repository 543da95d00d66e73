"""The restart supervisor and the heartbeat it reads (counterpart of
``deepspeed_tpu/elasticity/elastic_agent.py``; reference
``elasticity/elastic_agent.py:28`` ``DSElasticAgent``).

A launcher-level supervisor around a training command:

* liveness is the child's exit code and a heartbeat file the training loop
  refreshes (``DS_ELASTIC_HEARTBEAT_FILE``): a hang inside a device call
  reports no exit code, so a stale file is the hang detector. The file
  carries a small JSON payload (pid, monotonic clock, wall time and the
  caller's fields, the engine's ``global_step`` among them); its mtime is
  the liveness clock;
* recovery is a relaunch at the next world size of the ladder
  (``DS_ELASTIC_WORLD_SIZE``; ``[1]`` on one card), the restart count in
  ``DS_ELASTIC_RESTART_COUNT``, and the child's ``resume()`` continuing from
  its last durable tag.

The supervisor runs any argv. It imports neither ``torch`` nor the engine
and never touches the card: it must stay alive when the card is what hangs.
"""

import json
import logging
import os
import signal
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

HEARTBEAT_ENV = "DS_ELASTIC_HEARTBEAT_FILE"
WORLD_ENV = "DS_ELASTIC_WORLD_SIZE"
RESTART_ENV = "DS_ELASTIC_RESTART_COUNT"

_LAST_TOUCH: Dict[str, float] = {}  # path -> monotonic time of the last touch


def touch_heartbeat(path: Optional[str] = None, min_interval: float = 0.0,
                    payload: Optional[Dict] = None) -> None:
    """Refresh the heartbeat file; a no-op when no supervisor set one.

    ``min_interval`` skips the touch if this path was refreshed less than
    that many seconds ago. A payload-less call on an existing file only
    refreshes its mtime, so it never clobbers the process's progress
    record. The payload is published atomically (write, then rename)."""
    path = path or os.environ.get(HEARTBEAT_ENV)
    if not path:
        return
    if min_interval > 0.0:
        now = time.monotonic()
        if now - _LAST_TOUCH.get(path, float("-inf")) < min_interval:
            return
        _LAST_TOUCH[path] = now
    if payload is None and os.path.exists(path):
        os.utime(path, None)
        return
    data = {"pid": os.getpid(), "monotonic": time.monotonic(), "time": time.time()}
    if payload:
        data.update(payload)
    try:
        blob = json.dumps(data)
    except (TypeError, ValueError):  # an unserialisable caller field
        blob = json.dumps({k: data[k] for k in ("pid", "monotonic", "time")})
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            fh.write(blob)
        os.replace(tmp, path)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    os.utime(path, None)


def read_heartbeat(path: Optional[str] = None) -> Optional[Dict]:
    """The last heartbeat payload, or None (no file, an empty file, a torn
    write): a reader never fails on liveness metadata."""
    path = path or os.environ.get(HEARTBEAT_ENV)
    if not path:
        return None
    try:
        with open(path) as fh:
            blob = fh.read()
    except OSError:
        return None
    if not blob.strip():
        return None
    try:
        data = json.loads(blob)
    except json.JSONDecodeError:
        return None
    return data if isinstance(data, dict) else None


def heartbeat_age(path: Optional[str] = None, now: Optional[float] = None) -> Optional[float]:
    """Seconds since the heartbeat file was last touched, or None when there
    is no file. The mtime is the liveness clock (the payload's
    ``monotonic`` is the writer's clock)."""
    path = path or os.environ.get(HEARTBEAT_ENV)
    if not path:
        return None
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return None
    return max(0.0, (now if now is not None else time.time()) - mtime)


class DSElasticAgent:
    """Supervise a training command; on its death or heartbeat silence,
    restart it at the next world size.

    Args:
        cmd: argv of the job. It reads ``DS_ELASTIC_WORLD_SIZE``, refreshes
            the heartbeat (the engine does so every step) and resumes from
            its checkpoint dir on start.
        world_sizes: the ladder of world sizes; attempt ``restart_count``
            takes index ``restart_count`` (clamped to the last entry).
        heartbeat_timeout: seconds of heartbeat silence before the child is
            declared hung and killed.
        max_restarts: give up after this many restarts.
        env: extra environment for the child.
        startup_timeout: the silence allowed before the child's first touch
            (imports, model build, kernel loads); default
            ``max(heartbeat_timeout, 1800)``.
        on_restart: callback ``(restart_count, world_size)`` before each
            relaunch.
        checkpoint_dir: the job's checkpoint dir. When set, every history
            row records how the attempt resumes (``decide_resume``: fresh,
            plain, reshard), read from ``metadata.json`` stamps alone.
    """

    def __init__(self, cmd: Sequence[str], world_sizes: Sequence[int],
                 heartbeat_timeout: float = 60.0, max_restarts: int = 3,
                 env: Optional[dict] = None, poll_interval: float = 0.5,
                 startup_timeout: Optional[float] = None,
                 on_restart: Optional[Callable[[int, int], None]] = None,
                 checkpoint_dir: Optional[str] = None):
        if not world_sizes:
            raise ValueError("world_sizes ladder must be non-empty")
        self.cmd = list(cmd)
        self.world_sizes = list(world_sizes)
        self.checkpoint_dir = checkpoint_dir
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.startup_timeout = (float(startup_timeout) if startup_timeout is not None
                                else max(self.heartbeat_timeout, 1800.0))
        self.max_restarts = int(max_restarts)
        self.env = dict(env or {})
        self.poll_interval = float(poll_interval)
        self.on_restart = on_restart
        self.restart_count = 0
        self.history: List[dict] = []

    def validate_world_sizes(self, ds_config: dict) -> None:
        """Check that every ladder entry admits a valid elastic batch
        config (``compute_elastic_config`` raises otherwise), before the
        first launch."""
        from deepspeed_tpu_torch.elasticity.elasticity import compute_elastic_config
        for w in self.world_sizes:
            compute_elastic_config(ds_config, world_size=w)

    def _spawn(self, world_size: int, heartbeat_path: str) -> subprocess.Popen:
        env = dict(os.environ)
        env.update(self.env)
        env[WORLD_ENV] = str(world_size)
        env[HEARTBEAT_ENV] = heartbeat_path
        env[RESTART_ENV] = str(self.restart_count)
        # drop the previous attempt's record, so that a child that dies
        # before its first touch is not credited with the old payload; the
        # fresh record carries the supervisor's pid, which _run filters out
        try:
            os.unlink(heartbeat_path)
        except OSError:
            pass
        touch_heartbeat(heartbeat_path)
        return subprocess.Popen(self.cmd, env=env, process_group=0)  # its own group, for killpg

    def _kill(self, proc: subprocess.Popen) -> None:
        """SIGTERM the child's process group, SIGKILL after 10 s."""
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            try:
                proc.wait(timeout=10)
                return
            except subprocess.TimeoutExpired:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except ProcessLookupError:
            pass
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            logger.error("elastic agent: child survived SIGKILL; abandoning it")

    def run(self, workdir: Optional[str] = None) -> int:
        """Supervise until the job exits 0 or the restarts are spent.
        Returns the final exit code (0 on success)."""
        workdir = workdir or os.getcwd()
        # one file per agent: two supervisors sharing a workdir must not
        # keep each other's heartbeat fresh
        heartbeat_path = os.path.join(workdir, f".ds_elastic_heartbeat.{os.getpid()}")
        try:
            return self._run(heartbeat_path)
        finally:
            try:
                os.unlink(heartbeat_path)
            except OSError:
                pass

    def _resume_decision(self, world: int) -> Optional[Dict]:
        """How this attempt will come back up, from the stamps alone; None
        without a ``checkpoint_dir``. Never raises: bookkeeping must not
        take down a restartable job."""
        if not self.checkpoint_dir:
            return None
        try:
            from deepspeed_tpu_torch.runtime.elastic.agent import decide_resume
            return decide_resume(self.checkpoint_dir, world)
        except Exception as e:  # noqa: BLE001 (diagnostics only)
            logger.warning(f"elastic agent: cannot read checkpoint topology: {e}")
            return None

    def _run(self, heartbeat_path: str) -> int:
        prev_world: Optional[int] = None
        while True:
            world = self.world_sizes[min(self.restart_count, len(self.world_sizes) - 1)]
            decision = self._resume_decision(world)
            logger.info(f"elastic agent: launching attempt {self.restart_count + 1} at world size "
                        f"{world}" + (f" ({decision['resume']} resume from tag {decision['tag']})"
                                      if decision else ""))
            t0 = time.time()
            proc = self._spawn(world, heartbeat_path)
            armed_mtime = os.path.getmtime(heartbeat_path)
            while True:
                rc = proc.poll()
                if rc is not None:
                    reason = f"exit rc={rc}"
                    break
                try:
                    mt = os.path.getmtime(heartbeat_path)
                except FileNotFoundError:
                    # deleted under us: recreate it and keep supervising
                    touch_heartbeat(heartbeat_path)
                    armed_mtime = os.path.getmtime(heartbeat_path)
                    continue
                age = time.time() - mt
                # before the child's first touch the mtime is the arm-touch:
                # the startup budget applies, not the step budget
                budget = self.startup_timeout if mt <= armed_mtime else self.heartbeat_timeout
                if age > budget:
                    phase = "startup" if mt <= armed_mtime else "heartbeat"
                    reason = f"{phase} silent {age:.1f}s (hung backend)"
                    self._kill(proc)
                    # a graceful SIGTERM handler may exit 0: the agent
                    # declared this attempt dead, and rc must say so
                    rc = proc.returncode if proc.returncode not in (None, 0) else -9
                    break
                time.sleep(self.poll_interval)
            hb = read_heartbeat(heartbeat_path)
            if hb and hb.get("pid") == os.getpid():
                hb = None  # the arm-touch record: the child never reported
            progress = ({k: hb[k] for k in ("global_step", "last_span", "pid", "world_size",
                                            "mesh_axes") if k in hb} if hb else None)
            row = dict(world_size=world, rc=rc, reason=reason,
                       duration_s=round(time.time() - t0, 2), last_heartbeat=progress)
            # every row carries the whole key set; without a checkpoint_dir
            # the decision fields stay None
            topo = dict(prev_world_size=prev_world, world_size=world, resume=None, tag=None,
                        ckpt_world=None, ckpt_axes=None)
            topo.update(decision or {})
            row["topology"] = topo
            self.history.append(row)
            prev_world = world
            if rc == 0:
                logger.info(f"elastic agent: job finished at world size {world}")
                return 0
            if self.restart_count >= self.max_restarts:
                logger.error(f"elastic agent: giving up after {self.restart_count + 1} attempts "
                             f"({reason})")
                return rc if rc is not None else 1
            self.restart_count += 1
            next_world = self.world_sizes[min(self.restart_count, len(self.world_sizes) - 1)]
            logger.info(f"elastic agent: attempt failed ({reason}"
                        + (f"; last progress {progress}" if progress else "")
                        + f"); restarting at world size {next_world}")
            if self.on_restart is not None:
                self.on_restart(self.restart_count, next_world)
