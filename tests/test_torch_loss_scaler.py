"""The port's loss scaler (``runtime/fp16/loss_scaler.py``) against the JAX
package's, exactly.

Random overflow streams (seeded numpy) drive JAX's ``create_loss_scaler``
update (under ``jax.jit``) and the port's, static and dynamic, over
hysteresis, ``consecutive_hysteresis``, scale windows and a ``min_scale``
floor: the scale, the good steps and the hysteresis left must be equal at
every step (tolerance 0). ``has_overflow`` must flag the same trees, and
``OverflowWatcher`` fed the post-step scales must emit the same events.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_ls
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as port_ls


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SETTINGS = {
    "defaults": dict(),
    "hysteresis-1": dict(delayed_shift=1, init_scale=2.0**40),
    "window-3": dict(scale_window=3, delayed_shift=2),
    "consecutive": dict(scale_window=4, delayed_shift=3, consecutive_hysteresis=True),
    "floor": dict(init_scale=8.0, min_scale=2.0, delayed_shift=1, scale_window=2),
    "no-hysteresis": dict(delayed_shift=0, scale_window=5),
    "static": dict(static_loss_scale=128.0),
}


def _stream(seed, n=200):
    rng = np.random.default_rng(seed)
    # bursts: runs of overflows among good steps, as a diverging scale gives
    p = rng.uniform(0.05, 0.6)
    return [bool(x) for x in rng.random(n) < p]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", SETTINGS)
def test_scale_sequence_equals_jax(name, seed):
    kw = SETTINGS[name]
    jstate, jupdate = jax_ls.create_loss_scaler(**kw)
    pstate, pupdate = port_ls.create_loss_scaler(**kw)
    jupdate = jax.jit(jupdate)
    for step, overflow in enumerate(_stream(seed)):
        jstate = jupdate(jstate, jnp.asarray(overflow))
        pstate = pupdate(pstate, overflow)
        want = (float(jstate.loss_scale), int(jstate.good_steps), int(jstate.hysteresis))
        assert (pstate.loss_scale, pstate.good_steps, pstate.hysteresis) == want, (name, step)


def test_has_overflow_equals_jax():
    rng = np.random.default_rng(3)
    jit_has = jax.jit(jax_ls.has_overflow)
    for case in range(12):
        leaves = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
        if case % 3 == 1:
            leaves[case % 3][(0,) * leaves[case % 3].ndim] = np.inf
        if case % 4 == 2:
            leaves[2][1, 1, 1] = np.nan
        want = bool(jit_has([jnp.asarray(x) for x in leaves]))
        assert port_ls.has_overflow([torch.from_numpy(x) for x in leaves]) == want
    assert port_ls.has_overflow([]) is False


def test_watcher_events_equal_jax():
    kw = dict(scale_window=3, delayed_shift=1, init_scale=2.0**10)
    jstate, jupdate = jax_ls.create_loss_scaler(**kw)
    jw, pw = jax_ls.OverflowWatcher(abort_after=0), port_ls.OverflowWatcher(abort_after=0)
    for step, overflow in enumerate(_stream(4, 60)):
        jstate = jupdate(jstate, jnp.asarray(overflow))
        scale = float(jstate.loss_scale)
        assert pw.record(step, overflow, scale) == jw.record(step, overflow, scale)
    assert (pw.total_skipped, pw.longest_streak) == (jw.total_skipped, jw.longest_streak)
    cuts = [e for e in pw.record(99, True, 0.5) if e[0] == "Train/loss_scale_cut"]
    assert cuts == [("Train/loss_scale_cut", 0.5, 99)]


def test_abort_guard_raises_at_the_kth_skip():
    w = port_ls.OverflowWatcher(abort_after=3)
    w.record(0, True, 4.0)
    w.record(1, True, 2.0)
    with pytest.raises(port_ls.OverflowAbort, match="max_consecutive_overflows=3"):
        w.record(2, True, 1.0)
