"""The heartbeat of a supervised process (counterpart of the heartbeat
functions of ``deepspeed_tpu/elasticity/elastic_agent.py``).

A supervisor sets ``DS_ELASTIC_HEARTBEAT_FILE``; the process refreshes that
file as it makes progress, so a hang inside a device call (which no exit
code reports) shows as a stale file. The file carries a small JSON payload
(pid, monotonic clock, wall time and the caller's fields); its mtime stays
the liveness clock.
"""

import json
import os
import time
from typing import Dict, Optional

HEARTBEAT_ENV = "DS_ELASTIC_HEARTBEAT_FILE"

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
