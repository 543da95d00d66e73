"""The port's training-engine API against the JAX engine's.

One JAX run (module-scoped): GPT-2 "test" (2 layers, 64 wide, seq 64) with
an MoE FFN of 4 experts in layer 1 (top-1, RTS off, so that training-mode
routing draws nothing and both packages route alike), fp32, AdamW 1e-3,
clipping 1.0, ``train_batch_size`` 8 at ``gas`` 2: ``moe_gate_stats`` at
the initial weights, then 4 steps through the JAX ``forward`` /
``backward`` / ``step`` shims with ``retain_grads`` on. The port, started
from ``params_from_jax`` of the same weights, must give the same loss per
step within ``PARITY_RTOL``, the same gradients, Adam moments and
parameters (``tensor_fragment``, under the mapped names) and exactly the
same gate counts. The rest holds the port to itself: the shims equal
``train_batch`` bit for bit (dropout and RTS included), the accumulation
boundary, the dataloader against JAX's batch for batch, and a
``moe_gate_stats`` call leaving the next step as it was.
"""

import numpy as np
import pytest

import jax
import torch

import deepspeed_tpu
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.moe import routing as jax_routing
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu.runtime import dataloader as jax_dataloader
from deepspeed_tpu.utils import tensor_fragment as jax_fragment
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import _torch_key, params_from_jax
from deepspeed_tpu_torch.moe import routing
from deepspeed_tpu_torch.runtime import dataloader
from deepspeed_tpu_torch.utils import tensor_fragment

PARITY_RTOL = 1e-5
STEPS = 4
GAS = 2
MODEL = dict(n_layer=2, n_embd=64, n_head=4, n_positions=64, moe_num_experts=4,
             moe_layer_freq=2, moe_k=1, moe_use_rts=False)
CONFIG = {"train_batch_size": 8, "gradient_accumulation_steps": GAS,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "gradient_clipping": 1.0,
          "zero_optimization": {"stage": 0}, "steps_per_print": 10**9}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_route():
    routing.set_default_route(None, None)
    yield
    routing.set_default_route(None, None)


def _batches(n=STEPS):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (8, 64)).astype(np.int32) for _ in range(n)]


def _micro(batch, i):
    size = batch.shape[0] // GAS
    return {"input_ids": batch[i * size:(i + 1) * size]}


def _port_engine(init, config=CONFIG, **overrides):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **dict(MODEL, **overrides))
    model = deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu")
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=None if init is None else params_from_jax(init, cfg),
        config=config, device="cpu")
    return engine


def _shim_step(engine, batch):
    """One step through forward/backward/step; the mean micro-batch loss."""
    micro = []
    for i in range(GAS):
        loss = engine.forward(_micro(batch, i))
        engine.backward(loss)
        micro.append(loss.detach().float() if isinstance(loss, torch.Tensor) else float(loss))
    engine.step()
    if isinstance(micro[0], torch.Tensor):
        return torch.stack(micro).mean()
    return float(np.mean(micro))


def _close(got: torch.Tensor, want, what: str, rtol: float = PARITY_RTOL):
    """max |got - want| within ``rtol`` of max |want|."""
    want = np.asarray(want)
    err = float(np.max(np.abs(got.detach().cpu().numpy() - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol} x {scale:.3e}"
    return err / scale if scale else 0.0


@pytest.fixture(scope="module")
def jax_run():
    jax_routing.set_default_route(None, None)
    engine, _, _, _ = deepspeed_tpu.initialize(
        model=JaxGPT2(jax_config("test", dropout=0.0, **MODEL)),
        topology=MeshTopology(data=1, devices=jax.devices()[:1]), config=dict(CONFIG))
    batches = _batches()
    engine.initialize_state(_micro(batches[0], 0))
    out = {"init": jax.device_get(engine.state.params), "losses": []}
    out["stats"] = engine.moe_gate_stats({"input_ids": batches[0]})
    engine.retain_grads(True)
    names = jax_fragment.list_param_names(engine)
    for step, b in enumerate(batches):
        out["losses"].append(_shim_step(engine, b))
        if step == 0:
            out["step1"] = {
                "grad": {n: jax_fragment.safe_get_full_grad(engine, n) for n in names},
                "exp_avg": {n: jax_fragment.safe_get_full_optimizer_state(engine, n, "exp_avg")
                            for n in names},
                "exp_avg_sq": {n: jax_fragment.safe_get_full_optimizer_state(engine, n, "exp_avg_sq")
                               for n in names}}
    out["final"] = {n: jax_fragment.safe_get_full_fp32_param(engine, n) for n in names}
    out["global_steps"], out["micro_steps"] = engine.global_steps, engine.micro_steps
    return out


def test_shims_follow_the_jax_shims(jax_run):
    """Loss per step within 1e-5, and after step 1 (same weights on both
    sides) every retained gradient and Adam moment within 1e-5 of its
    tensor's largest value, under the mapped names (the parameters: the
    next test)."""
    engine = _port_engine(jax_run["init"])
    engine.retain_grads(True)
    losses = []
    worst = {}
    for step, b in enumerate(_batches()):
        losses.append(float(_shim_step(engine, b)))
        if step == 0:
            for n, want in jax_run["step1"]["grad"].items():
                name = _torch_key(n)
                worst["grad"] = max(worst.get("grad", 0), _close(
                    tensor_fragment.safe_get_full_grad(engine, name), want, f"grad {name}"))
                for key in ("exp_avg", "exp_avg_sq"):
                    worst[key] = max(worst.get(key, 0), _close(
                        tensor_fragment.safe_get_full_optimizer_state(engine, name, key),
                        jax_run["step1"][key][n], f"{key} {name}"))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, jax_run["losses"]))
    print(f"shims vs JAX: loss {rel:.3e}, step-1 tensors {worst}")  # pytest -s
    assert rel <= PARITY_RTOL, (losses, jax_run["losses"])
    assert (engine.global_steps, engine.micro_steps) == (jax_run["global_steps"],
                                                         jax_run["micro_steps"])
    assert sorted(map(_torch_key, jax_run["final"])) == tensor_fragment.list_param_names(engine)


def test_final_parameters_follow_jax(jax_run):
    """After 4 steps: each parameter within 1e-5 of the whole parameter
    set's norm. Adam divides each gradient by its own running rms, so a
    last-bit difference in a tiny gradient moves one weight by up to ~1% of
    lr (``test_torch_engine.py``), far more than 1e-5 of that weight."""
    engine = _port_engine(jax_run["init"])
    for b in _batches():
        _shim_step(engine, b)
    diff = sum(float(np.sum((tensor_fragment.safe_get_full_fp32_param(engine, _torch_key(n))
                             .numpy() - w) ** 2)) for n, w in jax_run["final"].items())
    norm = sum(float(np.sum(np.asarray(w) ** 2)) for w in jax_run["final"].values())
    print(f"final parameters vs JAX: relative norm {np.sqrt(diff / norm):.3e}")  # pytest -s
    assert np.sqrt(diff / norm) <= PARITY_RTOL


def test_moe_gate_stats_match_jax_exactly(jax_run):
    engine = _port_engine(jax_run["init"])
    got = engine.moe_gate_stats({"input_ids": _batches()[0]})
    want = {k.replace("/", "."): v for k, v in jax_run["stats"].items()}
    assert set(got) == set(want) == {"h_1.moe.deepspeed_moe"}
    for layer, entry in want.items():
        assert set(got[layer]) == set(entry)
        assert got[layer]["capacity_slots"] == entry["capacity_slots"]
        for key in ("exp_counts", "kept_counts", "routed_counts"):
            np.testing.assert_array_equal(got[layer][key], np.asarray(entry[key]), err_msg=key)
    assert engine.global_steps == 0 and engine.optimizer.count == 0


@pytest.mark.parametrize("variant", ["dense-dropout", "moe-rts-dropout"])
def test_shims_equal_train_batch_bit_for_bit(variant):
    """Two engines from one seeded init: ``train_batch`` on one, the same
    micro-batches through forward/backward/step on the other. Dropout and
    the RTS draws come from the engine's generator in the same order, so
    the losses and the parameters agree in every bit."""
    overrides = dict(dropout=0.1) if variant == "dense-dropout" else \
        dict(dropout=0.1, moe_use_rts=True)
    if variant == "dense-dropout":
        overrides["moe_num_experts"] = 0
    a, b = _port_engine(None, **overrides), _port_engine(None, **overrides)
    assert all(torch.equal(p, q) for p, q in zip(a.module.parameters(), b.module.parameters()))
    got_a = [a.train_batch(x) for x in _batches()]
    got_b = [_shim_step(b, x) for x in _batches()]
    assert all(torch.equal(x, y) for x, y in zip(got_a, got_b)), (got_a, got_b)
    for (name, p), q in zip(a.module.named_parameters(), b.module.parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert (a.global_steps, a.micro_steps, a.optimizer.count) == (b.global_steps, b.micro_steps,
                                                                  b.optimizer.count) == (4, 8, 4)


def test_gradient_accumulation_boundary():
    """JAX ``tests/unit/runtime/test_engine.py:151-164``: ``step()`` is a
    no-op mid-window and applies once at the boundary."""
    engine = _port_engine(None)
    micro = _micro(_batches(1)[0], 0)
    assert engine.gradient_accumulation_steps() == GAS
    engine.backward(engine.forward(micro))
    assert not engine.is_gradient_accumulation_boundary()
    before = [p.clone() for p in engine.module.parameters()]
    engine.step()
    assert engine.global_steps == 0
    assert all(torch.equal(p, q) for p, q in zip(before, engine.module.parameters()))
    with pytest.raises(RuntimeError, match="accumulation window"):
        engine.train_batch(_batches(1)[0])
    engine.backward(engine.forward(micro))
    assert engine.is_gradient_accumulation_boundary()
    engine.step()
    assert (engine.global_steps, engine.micro_steps, engine.global_samples) == (1, 2, 8)
    engine.step()  # a second step at the boundary has no window to apply
    assert engine.global_steps == 1 and engine.optimizer.count == 1


def test_train_batch_in_an_open_window_reads_no_data():
    """A ``train_batch`` refused inside an open window has not read its
    batch: the data order stays the one JAX gives."""
    engine = _port_engine(None)
    batches = _batches(2)
    it = iter(batches)
    engine.backward(engine.forward(_micro(batches[0], 0)))
    with pytest.raises(RuntimeError, match="accumulation window"):
        engine.train_batch(data_iter=it)
    np.testing.assert_array_equal(next(it), batches[0])


def test_backward_before_forward_raises():
    engine = _port_engine(None)
    with pytest.raises(RuntimeError, match="must follow forward"):
        engine.backward()
    loss = engine.forward(_micro(_batches(1)[0], 0))
    engine.backward(loss)
    with pytest.raises(RuntimeError, match="must follow forward"):
        engine.backward(loss)  # the pending loss was consumed


def _dataset(kind, n=22):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, (n, 64)).astype(np.int32)
    if kind == "dict":
        return {"input_ids": ids, "labels": ids[:, ::-1].copy()}
    if kind == "samples":
        return list(ids)
    return [{"input_ids": row, "labels": row[::-1].copy()} for row in ids]


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("kind", ["dict", "samples", "sample-dicts"])
def test_dataloader_yields_the_jax_batches(kind, drop_last):
    """Same dataset, seed and ``drop_last``: the same batches, in order,
    over three epochs, and through ``RepeatingLoader`` past an epoch."""
    data = _dataset(kind)
    port = dataloader.DeepSpeedDataLoader(data, batch_size=8, drop_last=drop_last, seed=7)
    ref = jax_dataloader.DeepSpeedDataLoader(data, batch_size=8, drop_last=drop_last, seed=7)
    assert len(port) == len(ref) == (2 if drop_last else 3)
    for _ in range(3):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype
    # JAX's loader returns before counting the epoch when it drops the last
    # batch, so under drop_last every epoch repeats one order; the port
    # keeps that, to give the same batches
    assert port.epoch == ref.epoch == (0 if drop_last else 3)
    port_it = dataloader.RepeatingLoader(dataloader.DeepSpeedDataLoader(data, 8, drop_last=drop_last))
    ref_it = jax_dataloader.RepeatingLoader(jax_dataloader.DeepSpeedDataLoader(data, 8,
                                                                               drop_last=drop_last))
    for _ in range(7):
        np.testing.assert_array_equal(next(port_it)["input_ids"], next(ref_it)["input_ids"])


def test_train_batch_consumes_the_training_data():
    """``initialize(training_data=...)`` returns ``deepspeed_io``'s loader
    (the config's seed and ``dataloader_drop_last``); ``train_batch()``
    with no batch steps through it across epochs, bit for bit as the same
    batches passed by hand."""
    data = _dataset("dict", n=20)
    config = dict(CONFIG, dataloader_drop_last=True, seed=11)
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **MODEL)
    fed, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"), config=config,
        training_data=data, device="cpu")
    assert isinstance(loader, dataloader.DeepSpeedDataLoader) and loader is fed.training_dataloader
    assert (len(loader), loader.drop_last, loader.seed, loader.batch_size) == (2, True, 11, 8)
    by_hand, _, none, _ = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"), config=config, device="cpu")
    assert none is None
    with pytest.raises(ValueError, match="training_data"):
        by_hand.train_batch()
    ref = jax_dataloader.DeepSpeedDataLoader(data, 8, drop_last=True, seed=11)
    want = [by_hand.train_batch(b) for b in list(ref) + list(ref)]  # two epochs
    got = [fed.train_batch() for _ in range(len(want))]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    extra = fed.train_batch(data_iter=iter(fed.deepspeed_io(data)))
    assert torch.isfinite(extra) and fed.global_steps == len(want) + 1


def test_tensor_fragment_getters_setters_and_retention(jax_run):
    """The setter writes in place; the retained gradient is the averaged one
    before clipping (its norm is the step's gradient norm, which a clip of
    1e-3 cuts by orders of magnitude)."""
    engine = _port_engine(jax_run["init"], dict(CONFIG, gradient_clipping=1e-3))
    name = "h_0.attn.c_attn.kernel"
    p = dict(engine.module.named_parameters())[name]
    assert tensor_fragment.safe_get_full_grad(engine, name) is None  # not retained
    value = torch.full_like(p, 0.5)
    ptr = p.data_ptr()
    tensor_fragment.safe_set_full_fp32_param(engine, name, value)
    assert p.data_ptr() == ptr and torch.equal(p, value)  # in place
    assert torch.equal(tensor_fragment.safe_get_full_fp32_param(engine, name), value)
    with pytest.raises(ValueError, match="shape mismatch"):
        tensor_fragment.safe_set_full_fp32_param(engine, name, torch.zeros(3))
    with pytest.raises(KeyError, match="no parameter"):
        tensor_fragment.safe_get_full_fp32_param(engine, "h_0.attn.nope")
    engine.retain_grads(True)
    _shim_step(engine, _batches(1)[0])
    grad = tensor_fragment.safe_get_full_grad(engine, name)
    assert grad.shape == p.shape and torch.isfinite(grad).all()
    retained = [tensor_fragment.safe_get_full_grad(engine, n)
                for n in tensor_fragment.list_param_names(engine)]
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in retained)))
    assert engine.get_global_grad_norm() > 0.1  # 100x the clip
    assert norm == pytest.approx(engine.get_global_grad_norm(), rel=1e-5)
    # the optimizer stepped the parameter set in place
    assert p.data_ptr() == ptr and not torch.equal(p, value)
    assert torch.equal(tensor_fragment.safe_get_full_optimizer_state(engine, name, "mu"),
                       engine.optimizer.state[p]["exp_avg"])
    engine.retain_grads(False)
    assert tensor_fragment.safe_get_full_grad(engine, name) is None


def test_moe_gate_stats_leave_the_next_step_unchanged(jax_run):
    """With RTS and dropout the stats forward draws noise, from its own
    generator: the next training loss, parameters and generator state are
    the same bits as without the call."""
    batches = _batches(2)
    a = _port_engine(jax_run["init"], moe_use_rts=True, dropout=0.1)
    b = _port_engine(jax_run["init"], moe_use_rts=True, dropout=0.1)
    a.train_batch(batches[0])
    b.train_batch(batches[0])
    state = a.generator.get_state()
    stats = a.moe_gate_stats(batches[1])
    assert torch.equal(a.generator.get_state(), state)
    assert int(stats["h_1.moe.deepspeed_moe"]["exp_counts"].sum()) == 8 * 64
    assert torch.equal(a.train_batch(batches[1]), b.train_batch(batches[1]))
    assert all(torch.equal(p, q) for p, q in zip(a.module.parameters(), b.module.parameters()))
    # seeded from (seed, global_steps): the same step draws the same routing
    again = a.moe_gate_stats(batches[1])
    np.testing.assert_array_equal(again["h_1.moe.deepspeed_moe"]["kept_counts"],
                                  a.moe_gate_stats(batches[1])["h_1.moe.deepspeed_moe"]["kept_counts"])


def test_accessor_surface():
    """The accessors JAX ``tests/unit/runtime/test_engine.py:207-235`` pins,
    as one card has them."""
    config = dict(CONFIG, gradient_clipping=0.7, steps_per_print=17, bf16={"enabled": True})
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", dtype=torch.bfloat16, **MODEL)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"), config=config, device="cpu")
    assert (engine.global_rank, engine.world_size, engine.dp_world_size,
            engine.mp_world_size) == (0, 1, 1, 1)
    assert (engine.train_batch_size(), engine.train_micro_batch_size_per_gpu(),
            engine.gradient_accumulation_steps()) == (8, 4, 2)
    assert engine.zero_optimization_stage() == 0
    assert engine.gradient_clipping() == 0.7 and engine.steps_per_print() == 17
    assert engine.bfloat16_enabled() is True and engine.fp16_enabled() is False
    assert engine.dynamic_loss_scale() is False and engine.wall_clock_breakdown() is False
    assert engine.zero_offload_optimizer() is None and engine.sparse_gradients_enabled() is False
