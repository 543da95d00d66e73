"""The port's BERT against the JAX package's.

BERT "test" (2 layers, 64 wide, 4 heads) in fp32 from the same weights
(``params_from_jax``): the MLM logits within 1e-5 of the largest logit and every
parameter's gradient of one seeded cotangent within 1e-5 of the largest
gradient entry, on the ``"xla"`` backend with
a ``[B, L]`` right-padding mask and on ``"flash"`` (its plain versions
here) with the mask's lengths as ``kv_lengths``, both against JAX's
``"xla"`` run (the port of ``test_bert_padding_uses_flash_natively``);
tokens past each row's length leave the valid logits bit-equal; the post-LN
PLD gate ``LN(x + b f(x) / keep)`` with the port's keep draws injected into
JAX's gate; 6 engine steps of ``BertForMaskedLM`` with ``bert_mlm_loss``
(``test_bert_mlm_trains``' setup, with a padding mask that the engine
forwards to the model) against JAX's engine within ``PARITY_RTOL``; and the
weights' round trip through ``params_from_jax`` and ``params_to_jax``; the
MLM decoder's product (``tied_logits``) on bf16 operands against JAX's einsum
with ``preferred_element_type=float32``: logits within 1e-6 of the largest,
gradients within one bf16 step of their largest entry.
"""

import flax.linen as fnn
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
import deepspeed_tpu.models.common as jax_common
from deepspeed_tpu.models.bert import (BertForMaskedLM as JaxBert, bert_mlm_loss as jax_mlm_loss,
                                       get_bert_config as jax_bert_config)
from deepspeed_tpu.parallel.topology import MeshTopology
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.models.bert import bert_mlm_loss, tied_logits
from deepspeed_tpu_torch.models.common import flatten_tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PARITY_RTOL = 1e-5
B, L = 2, 32
LENGTHS = (32, 19)


def _inputs():
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 256, (B, L)).astype(np.int32)
    types = rng.integers(0, 2, (B, L)).astype(np.int32)
    mask = (np.arange(L)[None] < np.asarray(LENGTHS)[:, None]).astype(np.int32)
    cot = rng.standard_normal((B, L, 256)).astype(np.float32)
    return ids, types, mask, cot


def _jax_grads(module, params, ids, types, mask, cot, **kw):
    def f(p):
        logits = module.apply({"params": p}, ids, types, mask, **kw)
        return jnp.sum(logits * cot), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return np.asarray(logits), {k: np.asarray(v) for k, v in flatten_tree(grads, "/").items()}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's "xla" run: its weights, logits and gradients."""
    module = JaxBert(jax_bert_config("test"))
    ids, types, mask, cot = _inputs()
    params = jax.device_get(fnn.meta.unbox(jax.jit(module.init)(jax.random.PRNGKey(0),
                                                                jnp.asarray(ids))["params"]))
    logits, grads = _jax_grads(module, params, ids, types, mask, cot)
    return {"params": params, "logits": logits, "grads": grads}


def _port(tree, **kw):
    cfg = deepspeed_tpu_torch.get_bert_config("test", **kw)
    model = deepspeed_tpu_torch.BertForMaskedLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


def _port_grads(model, **kw):
    ids, types, mask, cot = _inputs()
    model.zero_grad()
    logits = model(torch.from_numpy(ids).long(), torch.from_numpy(types).long(),
                   torch.from_numpy(mask), **kw)
    (logits * torch.from_numpy(cot)).sum().backward()
    # the pooler feeds no logit: no gradient reaches it (JAX's are zeros)
    grads = params_to_jax({n: torch.zeros_like(p) if p.grad is None else p.grad
                           for n, p in model.named_parameters()})
    return logits.detach().numpy(), grads


def _close(got, want, what, scale=None):
    err = float(np.max(np.abs(got - want)))
    assert err <= PARITY_RTOL * (scale or float(np.max(np.abs(want)))), (what, err)


def _close_grads(got, want):
    """Every gradient within 1e-5 of the largest gradient entry (the key
    bias's gradient is zero but for rounding: softmax ignores a shift shared
    by all keys)."""
    assert set(got) == set(want)
    scale = max(float(np.max(np.abs(g))) for g in want.values())
    for path, w in want.items():
        _close(got[path], w, path, scale)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_logits_and_gradients_match_jax(jax_ref, backend):
    logits, grads = _port_grads(_port(jax_ref["params"], attention_backend=backend))
    _close(logits, jax_ref["logits"], "logits")
    _close_grads(grads, jax_ref["grads"])


def test_padding_leaves_valid_logits_bit_equal(jax_ref):
    model = _port(jax_ref["params"], attention_backend="flash")
    ids, types, mask, _ = _inputs()
    other = ids.copy()
    for row, n in enumerate(LENGTHS):
        other[row, n:] = (other[row, n:] + 7) % 256
    with torch.no_grad():
        a, b = (model(torch.from_numpy(x).long(), torch.from_numpy(types).long(),
                      torch.from_numpy(mask)) for x in (ids, other))
    for row, n in enumerate(LENGTHS):
        assert torch.equal(a[row, :n], b[row, :n])
    assert not torch.equal(a[1, LENGTHS[1]:], b[1, LENGTHS[1]:])


def test_flash_refuses_a_mask_it_cannot_take(jax_ref):
    ids, types, mask, _ = _inputs()
    model = _port(jax_ref["params"], attention_backend="flash", flash_prefix_padding=False)
    with pytest.raises(ValueError, match="takes no bias, mask or dropout"):
        model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask))
    model = _port(jax_ref["params"], attention_backend="flash")
    with pytest.raises(ValueError, match="takes no bias, mask or dropout"):
        model(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask)[:, None, None, :])


def test_pld_post_ln_gate_matches_jax(jax_ref, monkeypatch):
    """The port draws the keep flags; JAX's gate is handed the same flags
    in its call order (layer by layer, attention before the MLP)."""
    theta = 0.5
    model = _port(jax_ref["params"], progressive_layer_drop=True)
    logits, grads = _port_grads(model, deterministic=False, pld_theta=theta,
                                generator=torch.Generator().manual_seed(5))
    keep = model.last_pld_keep.numpy().reshape(-1)
    assert 0 < keep.sum() < keep.size  # some kept, some dropped
    calls = iter(range(keep.size))

    def injected_gate(_module, branch, p):
        b = bool(keep[next(calls)])
        return (branch / p if b else jnp.zeros_like(branch)), b

    monkeypatch.setattr(jax_common, "pld_gate", injected_gate)
    module = JaxBert(jax_bert_config("test", progressive_layer_drop=True))
    want_logits, want_grads = _jax_grads(module, jax_ref["params"], *_inputs(), deterministic=False,
                                         pld_theta=theta)
    _close(logits, want_logits, "logits")
    _close_grads(grads, want_grads)
    assert not np.allclose(logits, jax_ref["logits"])  # the gate changed the network


CONFIG = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 2e-3}},
          "zero_optimization": {"stage": 1}, "steps_per_print": 10**9}


def _mlm_batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (8, 32)).astype(np.int32)
    labels = np.where(rng.random((8, 32)) < 0.15, ids, -100).astype(np.int32)
    lengths = rng.integers(16, 33, 8)
    lengths[0] = 32
    mask = (np.arange(32)[None] < lengths[:, None]).astype(np.int32)
    return {"input_ids": ids, "labels": labels, "attention_mask": mask}


@pytest.fixture(scope="module")
def jax_engine_run():
    engine, _, _, _ = deepspeed_tpu.initialize(
        model=JaxBert(jax_bert_config("test")), loss_fn=jax_mlm_loss, config=dict(CONFIG),
        topology=MeshTopology(data=1, devices=jax.devices()[:1]))
    batch = _mlm_batch()
    engine.initialize_state(batch)
    init = jax.device_get(engine.state.params)
    return init, [float(engine.train_batch(batch)) for _ in range(6)]


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_mlm_engine_matches_jax(jax_engine_run, backend):
    init, want = jax_engine_run
    cfg = deepspeed_tpu_torch.get_bert_config("test", attention_backend=backend)
    engine = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.BertForMaskedLM(cfg, device="cpu"),
        model_parameters=params_from_jax(init, cfg), config=dict(CONFIG), loss_fn=bert_mlm_loss,
        device="cpu")[0]
    batch = _mlm_batch()
    got = [float(engine.train_batch(batch)) for _ in range(6)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    assert rel <= PARITY_RTOL, (got, want)
    assert got[-1] < got[0]


def test_weights_round_trip(jax_ref):
    want = flatten_tree(jax_ref["params"], "/")
    sd = params_from_jax(jax_ref["params"])  # the config inferred from the tree
    assert sd["bert.layer_0.attention_ln.scale"].shape == (64,)
    back = params_to_jax(sd)
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], np.asarray(v)) for k, v in want.items())
    model = deepspeed_tpu_torch.BertForMaskedLM(deepspeed_tpu_torch.get_bert_config("test"),
                                                device="cpu")
    model.load_state_dict(sd)


def test_tied_logits_match_jax_einsum_in_bf16():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    word = (rng.standard_normal((256, 64)) * 0.05).astype(np.float32)
    g = rng.standard_normal((2, 8, 256)).astype(np.float32)

    def jax_side(x_, w_):
        def logits(a, b):
            return jnp.einsum("ble,ve->blv", a, b, preferred_element_type=jnp.float32)
        out, vjp = jax.vjp(logits, x_, w_)
        return (out, *vjp(jnp.asarray(g)))

    want = jax.jit(jax_side)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(word, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(word).to(torch.bfloat16).requires_grad_()
    out = tied_logits(xt, wt)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32 and xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    for got, ref, tol in zip((out, xt.grad, wt.grad), want, (1e-6, 2.0**-7, 2.0**-7)):
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.abs(got.detach().float().numpy() - ref).max() <= tol * np.abs(ref).max()
