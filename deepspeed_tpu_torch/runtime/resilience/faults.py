"""Deterministic fault injection by failure class (the port's copy of
``deepspeed_tpu/runtime/resilience/faults.py``).

Recovery that is never exercised is folklore. This module injects each
documented failure class on demand, so that tests and ``chip_smoke.py``
assert the documented recovery instead of assuming it:

* **process death**: ``DS_FAULT_SPEC`` arms the :func:`fault_point` hooks in
  the engine (the step boundary) and in the checkpoint publish path (right
  before the atomic rename), so a child under ``DSElasticAgent`` dies by
  SIGKILL at an exact, reproducible point;
* **storage corruption**: :func:`truncate_file`, :func:`bitflip_file` and
  :func:`corrupt_checkpoint` damage a published checkpoint the way a
  crashed writer or a rotting disk would;
* **poisoned numerics**: :func:`overflow_injected_loss` and
  :func:`poison_batch` drive non-finite gradients through the engine's real
  overflow skip (the abort-after-K guard);
* **flaky infrastructure**: :class:`FlakyCall` raises N errors shaped like a
  compile helper's HTTP 500 before it succeeds (retry-policy coverage).

``DS_FAULT_SPEC`` grammar: comma-separated ``point=action[@arg]``, e.g.
``step=sigkill@3`` (SIGKILL at the step-3 boundary) or
``ckpt_pre_rename=sigkill`` (die between staging and publish: the torn
save). Unarmed, every hook is one cached dict lookup.
"""

import os
import random
import signal
import time
from typing import Optional

import numpy as np

FAULT_ENV = "DS_FAULT_SPEC"

_spec_cache = None
_spec_raw = None


def parse_fault_spec(raw: Optional[str] = None) -> dict:
    """``"step=sigkill@3,ckpt_pre_rename=sigkill"`` ->
    ``{"step": ("sigkill", "3"), "ckpt_pre_rename": ("sigkill", None)}``."""
    spec = {}
    for item in (raw or "").split(","):
        item = item.strip()
        if not item:
            continue
        point, _, action = item.partition("=")
        action, _, arg = action.partition("@")
        if not point or not action:
            raise ValueError(f"bad {FAULT_ENV} entry {item!r}: want point=action[@arg]")
        spec[point.strip()] = (action.strip(), arg.strip() or None)
    return spec


def _active_spec() -> dict:
    global _spec_cache, _spec_raw
    raw = os.environ.get(FAULT_ENV, "")
    if raw != _spec_raw:  # re-parsed only when the variable changed
        _spec_raw, _spec_cache = raw, parse_fault_spec(raw)
    return _spec_cache


def _fire(action: str, point: str) -> None:
    if action == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)  # no cleanup, no exit hook: the real crash
    elif action == "exit1":
        os._exit(1)
    elif action == "hang":
        time.sleep(3600)
    else:
        raise ValueError(f"unknown fault action {action!r} at point {point!r}")


def fault_point(name: str, step: Optional[int] = None) -> None:
    """Injection hook: a no-op unless ``DS_FAULT_SPEC`` arms ``name`` (and,
    for a step-qualified point, the step matches the armed ``@arg``)."""
    spec = _active_spec()
    if name not in spec:
        return
    action, arg = spec[name]
    if arg is not None and step is not None and int(arg) != int(step):
        return
    _fire(action, name)


# ---------------------------------------------------------------------------
# storage corruption
# ---------------------------------------------------------------------------

def truncate_file(path: str, keep_fraction: float = 0.5) -> str:
    """Cut a file short: the mark of a writer killed mid-stream."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(0, int(size * keep_fraction)))
    return path


def bitflip_file(path: str, offset: Optional[int] = None, seed: int = 0) -> str:
    """Flip one bit (silent storage corruption); the byte and the bit are
    drawn from ``random.Random(seed)``."""
    size = os.path.getsize(path)
    if size <= 0:
        raise ValueError(f"cannot bitflip empty file {path}")
    rng = random.Random(seed)
    offset = rng.randrange(size) if offset is None else offset
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ (1 << rng.randrange(8))]))
    return path


def corrupt_checkpoint(base_dir: str, tag: str, mode: str = "truncate", seed: int = 0) -> str:
    """Damage a published tag deterministically: the largest file its
    manifest lists (ties broken by name; a ``state/*.pt``, not a JSON stub)
    is truncated or bit-flipped. Returns the damaged path."""
    from deepspeed_tpu_torch.runtime.resilience.manifest import read_manifest

    tag_dir = os.path.join(base_dir, str(tag))
    manifest = read_manifest(tag_dir)
    if manifest and manifest.get("files"):
        rel = max(sorted(manifest["files"]), key=lambda r: manifest["files"][r]["bytes"])
        victim = os.path.join(tag_dir, rel)
    else:  # a manifest-less tag: the largest file on disk
        candidates = [os.path.join(dp, f) for dp, _, fs in os.walk(tag_dir) for f in fs]
        if not candidates:
            raise FileNotFoundError(f"no files under {tag_dir}")
        victim = max(sorted(candidates), key=os.path.getsize)
    if mode == "truncate":
        return truncate_file(victim)
    if mode == "bitflip":
        return bitflip_file(victim, seed=seed)
    raise ValueError(f"unknown corruption mode {mode!r}")


# ---------------------------------------------------------------------------
# poisoned numerics
# ---------------------------------------------------------------------------

FAULT_BOOST_KEY = "fault_boost"


def poison_batch(batch: dict, boost: float = float("inf")) -> dict:
    """Add a per-sample ``fault_boost`` leaf (shape ``[B]``, so the engine
    splits it into micro-batches like any label). ``inf`` drives every
    gradient non-finite: the persistent-overflow class."""
    b = next(int(v.shape[0]) for v in batch.values() if len(getattr(v, "shape", ())) > 0)
    out = dict(batch)
    out[FAULT_BOOST_KEY] = np.full((b,), boost, np.float32)
    return out


def overflow_injected_loss(base_loss_fn=None):
    """A ``loss_fn`` that multiplies the real loss by ``max(fault_boost)``
    when the batch carries one (:func:`poison_batch`), and is exactly the
    base loss otherwise. The poison flows through the real gradient, norm
    and overflow-skip path; nothing is mocked."""
    def loss(outputs, batch):
        from deepspeed_tpu_torch.runtime.engine import default_causal_lm_loss
        base = (base_loss_fn or default_causal_lm_loss)(outputs, batch)
        if isinstance(batch, dict) and FAULT_BOOST_KEY in batch:
            return base * batch[FAULT_BOOST_KEY].max()
        return base
    return loss


# ---------------------------------------------------------------------------
# flaky infrastructure
# ---------------------------------------------------------------------------

def make_compile_helper_500() -> RuntimeError:
    """An exception carrying a remote compile helper's failure text, so that
    classifier coverage runs against the real message, not a paraphrase."""
    return RuntimeError("INTERNAL: http://127.0.0.1:8083/remote_compile: "
                        "HTTP 500: tpu_compile_helper subprocess exit code 1")


class FlakyCall:
    """Wrap ``fn`` to fail ``fails`` times (with ``exc_factory``'s error)
    before it succeeds: the transient-500 injector for retry tests."""

    def __init__(self, fn, fails: int, exc_factory=make_compile_helper_500):
        self.fn = fn
        self.remaining = int(fails)
        self.exc_factory = exc_factory
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.remaining > 0:
            self.remaining -= 1
            raise self.exc_factory()
        return self.fn(*args, **kwargs)
