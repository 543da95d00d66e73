"""MoQ (``quantize_training``) and the eigenvalue probe of the port against
the JAX package's.

- ``fake_quantize_stepped`` with nearest rounding at every bit width from 16
  down to 1, symmetric and asymmetric, one and four groups, and with the
  mixed-fp16 blend across a schedule: bit-equal to JAX's from 16 to 3 bits
  (XLA's float32 ``exp2`` included: ``exp2(15)`` is 32767.984 there); at the
  ternary and binary floors within four float32 ulps of max |x|: the group
  mean sums in another order, and the straight-through form ``x + (q - x)``
  turns an ulp of the level into up to an ulp of |x|.
- The bit schedule equal to JAX's at every step from 0 to 10^5, for nine
  periods and four start/target pairs (XLA's float32 ``log2(8192)`` is
  12.999999, and the port follows it).
- The straight-through gradient, the transform's >= 2-D rule, the period
  factors, the host ``Quantizer`` against JAX's, the quantizer ops
  (``quantize``/``dequantize``/``fake_quantize``, ``swizzle_quant``,
  ``quantized_reduction``) against JAX's.
- An engine curve: GPT-2 "test" (fp32) under JAX's MoQ test configuration,
  losses within 1e-5 of JAX's engine over 6 steps.
- Eigenvalues: JAX's quadratic cases; the per-layer values of the test
  GPT-2 on ``"xla"`` within 1e-3 relative of JAX's with JAX's start vectors
  injected, and the period factors equal; the probe on the ``"flash"``
  backend raises in both packages.

The port's stochastic rounding draws from a ``torch.Generator``, not from
threefry (a deliberate difference): the ops tests inject the noise.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.ops.quantizer import core as jax_core
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu.runtime import eigenvalue as jax_eig
from deepspeed_tpu.runtime import quantize as jax_q
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import _torch_key, params_from_jax
from deepspeed_tpu_torch.ops.quantizer import core as port_core
from deepspeed_tpu_torch.runtime import eigenvalue as port_eig
from deepspeed_tpu_torch.runtime import quantize as port_q


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FLOOR_RTOL = 4 * float(np.finfo(np.float32).eps)
CURVE_RTOL = 1e-5
EIG_RTOL = 1e-3


def _x(seed, shape=(64, 48)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(x, step, **kw):
    want = np.asarray(jax_q.fake_quantize_stepped(jnp.asarray(x), jnp.asarray(step), **kw))
    got = port_q.fake_quantize_stepped(torch.from_numpy(x), step, **kw).numpy()
    return got, want


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("groups", [1, 4])
def test_fake_quantize_stepped_equals_jax_at_every_width(groups, symmetric):
    x = _x(groups + 2 * symmetric)
    for bits in range(16, 0, -1):
        got, want = _both(x, 5, start_bits=bits, target_bits=bits, period=10, groups=groups,
                          symmetric=symmetric)
        if bits >= 3:
            np.testing.assert_array_equal(got, want, err_msg=f"{bits} bits")
        else:
            np.testing.assert_allclose(got, want, atol=FLOOR_RTOL * np.abs(x).max(), rtol=0,
                                       err_msg=f"{bits} bits")
        if bits <= 8:  # each group holds at most 2^bits levels (3 ternary, 2 binary)
            for row in np.round(got, 5).reshape(groups, -1):
                assert len(np.unique(row)) <= (2**bits if bits >= 3 else bits + 1)
    for step in (0, 3, 10, 25, 47, 100, 10_000):
        got, want = _both(x, step, start_bits=8, target_bits=2, period=10, groups=groups,
                          symmetric=symmetric, mixed_fp16=True, change_ratio=0.01)
        np.testing.assert_allclose(got, want, atol=FLOOR_RTOL * np.abs(x).max(), rtol=0,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("start,target", [(16, 8), (8, 4), (16, 1), (12, 2)])
def test_bit_schedule_equals_jax_for_every_step(start, target):
    steps = np.arange(100_001)
    periods = (1, 2, 3, 5, 7, 10, 64, 100, 1000)
    # one JAX program for every period (a period array gives the same float32
    # arithmetic as a Python int)
    want = np.asarray(jax.jit(lambda s, p: jax_q.moq_bits_at(s, start, target, p))(
        jnp.asarray(steps)[:, None], jnp.asarray(periods, jnp.int32)[None, :]))
    for i, period in enumerate(periods):
        got = port_q.moq_bits_at(torch.from_numpy(steps), start, target, period).numpy()
        np.testing.assert_array_equal(got, want[:, i], err_msg=f"period {period}")
    assert float(port_q.moq_bits_at(100, 8, 4, 100)) == 7.0


def test_straight_through_gradient_and_transform_rules():
    w = torch.from_numpy(_x(3, (16, 16))).requires_grad_()
    q = port_q.fake_quantize_stepped(w, 1000, start_bits=8, target_bits=4, period=10)
    (q * q).sum().backward()
    assert torch.equal(w.grad, 2 * q.detach())  # d/dw of sum(q^2), q taken as w
    params = {"wte": torch.ones(8, 4), "bias": torch.ones(4), "scalar": torch.ones(())}
    t = port_q.build_moq_transform(params, {"enabled": True, "quantize_bits": {
        "start_bits": 8, "target_bits": 4}, "quantize_period": 10})
    assert t.names == ("wte",) and set(t(params, 1000)) == {"wte"}
    assert port_q.build_moq_transform(params, {"enabled": False}) is None
    rng = np.random.default_rng(5)
    tree = {"h_0": {"w": rng.normal(size=(32, 32)).astype(np.float32)},
            "h_1": {"w": rng.normal(size=(32, 32)).astype(np.float32)}}
    flat = {f"{k}.w": torch.from_numpy(v["w"]) for k, v in tree.items()}
    cfg = {"enabled": True, "quantize_bits": {"start_bits": 8, "target_bits": 4},
           "quantize_period": 10, "quantize_groups": 4}
    for factors in (None, {"h_1": 100.0}):
        got = port_q.build_moq_transform(flat, cfg, factors)(flat, 500)
        want = jax_q.build_moq_transform(jax.tree.map(jnp.asarray, tree), cfg, factors)(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(500))
        for k in tree:
            np.testing.assert_array_equal(got[f"{k}.w"].numpy(), np.asarray(want[k]["w"]))


def test_host_quantizer_equals_jax():
    kw = dict(q_groups=2, q_mixed_fp16=True, q_change_ratio=0.1)
    port, ref = port_q.Quantizer(**kw), jax_q.Quantizer(**kw)
    x = _x(2, (4, 8))
    p_port = {"value": torch.from_numpy(x), "start_bits": 6, "target_bits": 2, "q_period": 1,
              "name": "w"}
    p_ref = {"value": jnp.asarray(x), "start_bits": 6, "target_bits": 2, "q_period": 1, "name": "w"}
    for i in range(7):
        port.quantize([[p_port]], overflow=False, eigenvalue_enabled=False,
                      block_eigenvalue={"w": 0.3})
        ref.quantize([[p_ref]], overflow=False, eigenvalue_enabled=False, block_eigenvalue={"w": 0.3})
        assert (p_port["start_bits"], p_port["q_period"]) == (p_ref["start_bits"], p_ref["q_period"])
        want = np.asarray(p_ref["value"])
        np.testing.assert_allclose(p_port["value"].numpy(), want,
                                   atol=FLOOR_RTOL * np.abs(x).max(), rtol=0, err_msg=f"call {i}")
    assert port.quantize_real_ratio == ref.quantize_real_ratio


@pytest.mark.parametrize("symmetric,bits,groups", [(True, 8, 4), (False, 8, 3), (True, 4, 6)])
def test_quantizer_ops_equal_jax(symmetric, bits, groups):
    x = _x(7, (6, 20))
    q, p = port_core.quantize(torch.from_numpy(x), bits, symmetric, groups)
    jq, jp = jax_core.quantize(jnp.asarray(x), bits, symmetric, groups)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(p.scale.numpy(), np.asarray(jp.scale))
    np.testing.assert_array_equal(port_core.dequantize(q, p, x.shape).numpy(),
                                  np.asarray(jax_core.dequantize(jq, jp, x.shape)))
    np.testing.assert_array_equal(
        port_core.fake_quantize(torch.from_numpy(x), bits, symmetric, groups).numpy(),
        np.asarray(jax_core.fake_quantize(jnp.asarray(x), bits, symmetric, groups)))
    # stochastic rounding with JAX's draws injected
    key = jax.random.PRNGKey(groups)
    noise = np.asarray(jax.random.uniform(key, (groups, x.size // groups), jnp.float32))
    sq, _ = port_core.quantize(torch.from_numpy(x), bits, symmetric, groups, stochastic_rounding=True,
                               noise=torch.from_numpy(noise))
    jsq, _ = jax_core.quantize(jnp.asarray(x), bits, symmetric, groups, stochastic_rounding=True,
                               rng=key)
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jsq))
    if symmetric:
        sw, swp = port_core.swizzle_quant(torch.from_numpy(x), bits, groups, pipeline_size=1, nodes=2,
                                          devices_per_node=3)
        jsw, jswp = jax_core.swizzle_quant(jnp.asarray(x), bits, groups, pipeline_size=1, nodes=2,
                                           devices_per_node=3)
        np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
        r, rp = port_core.quantized_reduction(q, p, bits, 4, devices=2)
        jr, jrp = jax_core.quantized_reduction(jq, jp, bits, 4, devices=2)
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_allclose(rp.scale.numpy(), np.asarray(jrp.scale), rtol=1e-6)


MOQ = {"enabled": True, "quantize_bits": {"start_bits": 8, "target_bits": 4}, "quantize_period": 2,
       "quantize_groups": 4}
EIGEN = {"enabled": True, "max_iter": 4, "tol": 0.1, "layer_name": "h", "layer_num": 2}
CONFIG = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "steps_per_print": 10**9, "zero_optimization": {"stage": 0}}


def _batch():
    return {"input_ids": np.random.default_rng(0).integers(0, 250, (8, 32)).astype(np.int32)}


def _jax_engine(config, **model_kw):
    return deepspeed_tpu.initialize(
        model=JaxGPT2(jax_config("test", dropout=0.0, n_positions=32, **model_kw)), config=dict(config),
        topology=MeshTopology(data=1, devices=jax.devices()[:1]))[0]


def _port_engine(tree, config, **model_kw):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", dropout=0.0, n_positions=32, **model_kw)
    model = deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu")
    weights = None if tree is None else params_from_jax(tree, cfg)
    return deepspeed_tpu_torch.initialize(model=model, model_parameters=weights, config=dict(config),
                                          device="cpu")[0]


@pytest.fixture(scope="module")
def jax_moq():
    """JAX's engine under MoQ: initial weights, its eigenvalue probe's
    per-layer values, start vectors and period factors (as the eigenvalue
    block would give them), and 6 losses."""
    engine = _jax_engine(dict(CONFIG, quantize_training=MOQ))
    batch = _batch()
    engine.initialize_state(batch)
    params = jax.device_get(engine.state.params)
    vocab, seq = 256, 32  # JAX's probe: [micro, min(n_positions, 128)]
    probe = {"input_ids": np.random.default_rng(0).integers(0, vocab, (8, seq)).astype(np.int32)}

    def loss_fn(p):
        return engine._loss_for(p, probe, jax.random.PRNGKey(0), jnp.float32(1.0), train=False)[1]

    ev = jax_eig.Eigenvalue(max_iter=EIGEN["max_iter"], tol=EIGEN["tol"], layer_name="h", layer_num=2)
    # jitted: the same loss, and a cold run takes a quarter of the op-by-op time
    eigs = ev.compute_eigenvalue(jax.jit(loss_fn), engine.state.params, scrub=False)
    starts = []
    for i in range(2):
        leaves = jax.tree_util.tree_flatten_with_path(params[f"h_{i}"])[0]
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), i), len(leaves))
        starts.append({f"h_{i}." + _torch_key("/".join(str(getattr(k, "key", k)) for k in path)):
                       torch.from_numpy(np.array(jax.random.normal(key, leaf.shape, jnp.float32)))
                       for (path, leaf), key in zip(leaves, keys)})
    # JAX's engine probe at init turns the same eigenvalues (the same loss,
    # parameters and default key) into factors: its own code, fed the values
    # computed above rather than running the probe a second time
    engine.config.raw_dict["eigenvalue"] = EIGEN
    probe = jax_eig.Eigenvalue.compute_eigenvalue
    jax_eig.Eigenvalue.compute_eigenvalue = lambda self, *a, **kw: list(eigs)
    try:
        factors = engine._moq_eigenvalue_factors()
    finally:
        jax_eig.Eigenvalue.compute_eigenvalue = probe
        del engine.config.raw_dict["eigenvalue"]
    losses = [float(engine.train_batch(batch)) for _ in range(6)]
    return dict(init=params, eigs=eigs, starts=starts, factors=factors, losses=losses)


VARIANTS = {"xla": {}, "remat": dict(remat=True),
            "flash-remat-fused": dict(remat=True, attention_backend="flash", fused_head_loss_chunk=64)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_moq_curve_matches_jax(jax_moq, variant):
    """JAX's curve (``"xla"``, no remat): the quantized masters are what
    every forward and remat recompute reads, so the variants give it too."""
    engine = _port_engine(jax_moq["init"], dict(CONFIG, quantize_training=MOQ), **VARIANTS[variant])
    want = jax_moq["losses"]
    got = [float(engine.train_batch(_batch())) for _ in range(6)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    assert rel <= CURVE_RTOL, (got, want)
    assert engine._moq is not None and len(engine._moq.names) == 12
    assert all(torch.equal(p, engine._moq_params[n]) for n, p in engine.module.named_parameters()
               if n in engine._moq_params)  # the masters are back between steps


def test_gradients_are_the_quantized_models():
    """Under remat and the flash backend, a MoQ step's gradients equal the
    plain model's at the quantized weights (the straight-through estimator)."""
    kw = dict(remat=True, attention_backend="flash")
    engine = _port_engine(None, dict(CONFIG, quantize_training=MOQ), **kw)
    for _ in range(3):
        engine.train_batch(_batch())
    quantized = engine._moq(engine._moq_params, engine.global_steps)
    twin = _port_engine(None, CONFIG, **kw)
    with torch.no_grad():
        mine = dict(engine.module.named_parameters())
        for n, p in twin.module.named_parameters():
            p.copy_(quantized[n] if n in quantized else mine[n])
    for e in (engine, twin):
        e.retain_grads()
        e.train_batch(_batch())
    assert torch.equal(engine._retained_grads, twin._retained_grads)


def test_eval_and_checkpoints_between_forward_and_backward(jax_moq, tmp_path):
    """Under remat, an ``eval_batch`` between a forward and its backward
    leaves that forward's quantized weights in place for the backward's
    recompute: the gradients equal those without it, bit for bit. A save or
    a load in that window raises; a forward without grad swaps the masters
    back at once."""
    grads = []
    for interleave in (False, True):
        engine = _port_engine(jax_moq["init"], dict(CONFIG, quantize_training=MOQ), remat=True)
        engine.train_batch(_batch())
        loss = engine.forward(_batch())
        if interleave:
            engine.eval_batch(_batch())
            assert engine._moq_masters is not None  # the forward's swap stays
            for call in (engine.save_checkpoint, engine.load_checkpoint):
                with pytest.raises(RuntimeError, match="between forward"):
                    call(str(tmp_path))
        engine.backward(loss)
        assert engine._moq_masters is None
        grads.append(engine._grads.clone())
        masters = {n: p.data_ptr() for n, p in engine._moq_params.items()}
        with torch.no_grad():
            engine.forward(_batch())
        assert engine._moq_masters is None
        assert {n: p.data_ptr() for n, p in engine._moq_params.items()} == masters
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("zero", [{"stage": 3, "offload_param": {"device": "cpu"}},
                                  {"stage": 2, "offload_optimizer": {"device": "cpu"}}],
                         ids=["offload_param", "offload_optimizer"])
def test_moq_with_eigenvalue_refused_under_offload_at_initialize(zero):
    """JAX applies MoQ on neither offload path; the port refuses the pair at
    ``initialize``, before any eigenvalue probe (whose HVP would need a second
    derivative through ``stream_in``, which the port refuses)."""
    config = dict(CONFIG, quantize_training=MOQ, eigenvalue=EIGEN, zero_optimization=zero)
    with pytest.raises(ValueError, match="does not compose with offload"):
        _port_engine(None, config)


def test_eigenvalues_and_factors_match_jax(jax_moq):
    engine = _port_engine(jax_moq["init"], dict(CONFIG, quantize_training=MOQ, eigenvalue=EIGEN))
    probe = engine._stage({"input_ids": np.random.default_rng(0).integers(0, 256, (8, 32)).astype(np.int32)})
    ev = port_eig.Eigenvalue(max_iter=EIGEN["max_iter"], tol=EIGEN["tol"], layer_name="h", layer_num=2)
    params = dict(engine.module.named_parameters())  # the engine's probe differentiates these
    eigs = ev.compute_eigenvalue(lambda p: engine._loss_for(probe, train=False), params,
                                 scrub=False, init_vectors=jax_moq["starts"])
    np.testing.assert_allclose(eigs, jax_moq["eigs"], rtol=EIG_RTOL)
    max_eig = max(eigs)
    assert {f"h_{i}": 1.0 + math.floor(e / max_eig * 4) for i, e in enumerate(eigs)} == jax_moq["factors"]
    # the engine's own probe (its start vectors drawn by torch): finite factors in [1, 5]
    factors = engine._moq_eigenvalue_factors()
    assert set(factors) == {"h_0", "h_1"} and all(1.0 <= f <= 5.0 for f in factors.values())
    losses = [float(engine.train_batch(_batch())) for _ in range(2)]
    assert all(np.isfinite(losses))


def test_eigenvalue_probe_on_flash_raises_in_both():
    config = dict(CONFIG, quantize_training=MOQ, eigenvalue=dict(EIGEN, max_iter=1))
    jax_engine = _jax_engine(config, attention_backend="flash")
    with pytest.raises(Exception):
        jax_engine.train_batch(_batch())
    engine = _port_engine(jax.device_get(jax_engine.state.params), config, attention_backend="flash")
    with pytest.raises(RuntimeError, match="differentiate twice"):
        engine.train_batch(_batch())


def test_quadratic_eigenvalues_as_jax():
    d = torch.tensor([1.0, 7.5, 3.0, 0.25])
    eig = port_eig.hessian_top_eigenvalue(lambda p: 0.5 * (d * p["x"] * p["x"]).sum(),
                                          {"x": torch.ones(4)}, max_iter=200, tol=1e-6,
                                          generator=torch.Generator().manual_seed(0))
    assert eig == pytest.approx(7.5, rel=1e-3)
    curv = {"h_0": 2.0, "h_1": 9.0}
    params = {"h_0.w": torch.ones(3), "h_1.w": torch.ones(2)}
    ev = port_eig.Eigenvalue(max_iter=200, tol=1e-6, layer_name="h", layer_num=2)
    eigs = ev.compute_eigenvalue(lambda p: sum(0.5 * c * p[f"{k}.w"].square().sum()
                                               for k, c in curv.items()), params)
    assert eigs == pytest.approx([2.0, 9.0], rel=1e-3)
    # a layer without curvature takes the max, as in JAX
    eigs = ev.compute_eigenvalue(lambda p: 2.0 * p["h_0.w"].square().sum(), params)
    ref = jax_eig.Eigenvalue(max_iter=200, tol=1e-6, layer_name="h", layer_num=2).compute_eigenvalue(
        lambda p: 2.0 * jnp.sum(jnp.square(p["h_0"]["w"])), {"h_0": {"w": jnp.ones(3)},
                                                            "h_1": {"w": jnp.ones(2)}})
    assert eigs == pytest.approx(ref, rel=1e-3) and eigs[1] == eigs[0]
    with pytest.raises(KeyError, match="h_2"):
        port_eig.Eigenvalue(layer_name="h", layer_num=3).compute_eigenvalue(lambda p: 0.0, params)
