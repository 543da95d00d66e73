"""The port's ``FusedAdam`` and LR schedules against the JAX package's.

The same seeded numpy parameters and per-step gradients go through JAX
``fused_adam`` (applied with ``optax.apply_updates``) and through the port's
optimizer for several steps; parameters and both moments are compared
after every step. fp32 throughout, ``rtol=1e-6`` and ``atol=1e-7``: the
formulas are the same op for op, and only ``b**count`` (XLA's pow against
PyTorch's) may differ in its last bit. Each schedule is compared with the
JAX one at every step from 0 to 40 at ``rtol=1e-6`` (both evaluate in fp32;
log and pow may differ in the last bit).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deepspeed_tpu.ops.adam.fused_adam import fused_adam as jax_fused_adam
from deepspeed_tpu.runtime.lr_schedules import get_lr_schedule as jax_get_lr_schedule
from deepspeed_tpu_torch.ops.adam import FusedAdam
from deepspeed_tpu_torch.runtime.lr_schedules import VALID_LR_SCHEDULES, get_lr_schedule


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = {"kernel": (8, 5), "bias": (5,), "scale": (3, 2, 4)}
STEPS = 6


def _grads(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _run(kwargs, jax_lr=None, port_lr=None):
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    tx = jax_fused_adam(lr=jax_lr if jax_lr is not None else 1e-2, **kwargs)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = FusedAdam(tp.values(), lr=port_lr if port_lr is not None else 1e-2, **kwargs)
    for step in range(STEPS):
        grads = _grads(rng, scale=10.0 ** (step % 3 - 1))
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        assert opt.count == int(state.count) == step + 1
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} after step {step + 1}")
            np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), np.asarray(state.exp_avg[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(),
                                       np.asarray(state.exp_avg_sq[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kwargs", [
    dict(adam_w_mode=True, weight_decay=0.01),
    dict(adam_w_mode=False, weight_decay=0.01),
    dict(adam_w_mode=True, weight_decay=0.0),
    dict(adam_w_mode=True, weight_decay=0.1, bias_correction=False),
    dict(adam_w_mode=False, weight_decay=0.05, betas=(0.8, 0.95), eps=1e-6),
], ids=["adamw-wd", "l2-wd", "adamw-no-wd", "adamw-no-bias-correction", "l2-betas-eps"])
def test_fused_adam_matches_jax(kwargs):
    _run(kwargs)


def test_fused_adam_reads_schedule_at_incremented_count():
    params = dict(warmup_min_lr=0.0, warmup_max_lr=0.05, warmup_num_steps=4, warmup_type="linear")
    _run(dict(weight_decay=0.01), jax_lr=jax_get_lr_schedule("WarmupLR", params),
         port_lr=get_lr_schedule("WarmupLR", params))


def test_amsgrad_raises():
    with pytest.raises(NotImplementedError):
        FusedAdam([torch.nn.Parameter(torch.zeros(2))], amsgrad=True)


SCHEDULES = {
    "WarmupLR": [dict(warmup_min_lr=1e-4, warmup_max_lr=1e-2, warmup_num_steps=10),
                 dict(warmup_max_lr=3e-3, warmup_num_steps=7, warmup_type="linear")],
    "WarmupDecayLR": [dict(total_num_steps=30, warmup_max_lr=1e-2, warmup_num_steps=8),
                      dict(total_num_steps=25, warmup_min_lr=1e-5, warmup_num_steps=5,
                           warmup_type="linear")],
    "OneCycle": [dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2, cycle_first_step_size=10),
                 dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2, cycle_first_step_size=6,
                      cycle_second_step_size=9, decay_step_size=4, decay_lr_rate=0.5)],
    "LRRangeTest": [dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=5),
                    dict(lr_range_test_min_lr=1e-3, lr_range_test_step_size=4,
                         lr_range_test_step_rate=2.0, lr_range_test_staircase=True)],
}


@pytest.mark.parametrize("name", VALID_LR_SCHEDULES)
def test_lr_schedules_match_jax(name):
    for params in SCHEDULES[name]:
        jax_sched = jax_get_lr_schedule(name, params)
        sched = get_lr_schedule(name, params)
        got = np.asarray([sched(step) for step in range(41)], np.float32)
        want = np.asarray([float(jax_sched(jnp.int32(step))) for step in range(41)], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=f"{name} {params}")


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown lr schedule"):
        get_lr_schedule("Cosine", {})
