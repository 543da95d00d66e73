"""The port's in-flight RLHF loop (``runtime/rlhf``) against the JAX
package's.

The JAX test's policy-gradient setup (GPT-2 "test", 1 layer, 8 prompt and
8 new tokens, 8 slots, reward = share of even output tokens) with weights
re-drawn at N(0, 0.15) in both packages, so that greedy rollouts are
clear-cut, in fp32 on the CPU. The loop end to end must bank the same
experience tokens and give the same learner losses within 1e-5 per step.
On the port: a hot swap of identical weights mid-decode changes no token
(fp and int8 served weights), a drifted state dict, a wrong digest and a
digest under int8 are refused, a LoRA fuse -> rollout -> unfuse excursion
leaves training bit-identical, and a preemption after the first learner
step drains with nothing dropped, checkpoints once, and a fresh engine's
resume finishes on disjoint steps with the uninterrupted run's loss bits
(``align_cohorts``). The ``rlhf_weight_sync`` events the loop emits
validate against the schema.
"""

import os

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
from deepspeed_tpu.inference.serving import Request as JaxRequest, ServingConfig as JaxServingConfig
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu.runtime.rlhf import RolloutConfig as JaxRolloutConfig, RolloutLoop as JaxRolloutLoop
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.inference.serving import Request, ServingConfig, validate_event
from deepspeed_tpu_torch.inference.serving.events import iter_serve_events
from deepspeed_tpu_torch.models.common import flatten_tree, nest_tree
from deepspeed_tpu_torch.runtime.resilience.signals import PreemptionGuard
from deepspeed_tpu_torch.runtime.rlhf import Experience, RolloutConfig, RolloutLoop
from deepspeed_tpu_torch.runtime.telemetry import TELEMETRY_FILE, RuntimeTelemetry, TelemetryConfig

PROMPT, NEW = 8, 8
PARITY_ATOL = 1e-5
MODEL = dict(n_layer=1, n_positions=PROMPT + NEW, dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(batch_size=8):
    return {"train_batch_size": batch_size, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "hybrid_engine": {"enabled": True, "max_out_tokens": PROMPT + NEW}}


@pytest.fixture(scope="module")
def tree():
    """Seeded JAX GPT-2 weights re-drawn N(0, 0.15) (norm scales ~1)."""
    module = JaxGPT2(jax_config("test", **MODEL))
    init = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    init = jax.device_get(flax.linen.meta.unbox(init))
    rng = np.random.default_rng(5)
    flat = flatten_tree(init, "/")
    out = {}
    for key in sorted(flat):
        leaf = np.asarray(flat[key])
        out[key] = ((1.0 + rng.normal(0, 0.1, leaf.shape)) if key.endswith("scale")
                    else rng.normal(0, 0.15, leaf.shape)).astype(leaf.dtype)
    return nest_tree(out, "/")


def _loss_fn(logits, batch):
    adv, mask = batch["advantage"], batch["mask"].float()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = torch.gather(logp, -1, batch["rollouts"][:, 1:, None].long())[..., 0]
    return -(adv[:, None] * tgt * mask[:, 1:]).sum() / mask[:, 1:].sum().clamp_min(1.0)


def _jax_loss_fn(logits, batch):
    adv = batch["advantage"]
    mask = batch["mask"].astype(jnp.float32)
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    tgt = jnp.take_along_axis(logp, batch["rollouts"][:, 1:, None], axis=-1)[..., 0]
    return -(adv[:, None] * tgt * mask[:, 1:]).sum() / jnp.maximum(mask[:, 1:].sum(), 1.0)


def _engine(tree, n_layer=1):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **dict(MODEL, n_layer=n_layer))
    params = params_from_jax(tree) if n_layer == MODEL["n_layer"] else None
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"), model_parameters=params,
        config=_config(), loss_fn=_loss_fn, device="cpu")
    return engine


def _pad(pairs, adv, dtype=np.int64):
    width = PROMPT + NEW
    toks = np.zeros((len(pairs), width), dtype)
    mask = np.zeros((len(pairs), width), np.float32)
    for j, (p, o) in enumerate(pairs):
        seq = np.concatenate([np.asarray(p), np.asarray(o)])[:width]
        toks[j, :len(seq)] = seq
        mask[j, len(p):len(seq)] = 1.0
    return {"input_ids": toks, "rollouts": toks, "advantage": np.asarray(adv, np.float32),
            "mask": mask}


def _batcher(seen, dtype=np.int64):
    def make_batch(exps):
        seen.append([e.tokens for e in exps])
        pairs = [(e.prompt, e.output) for e in exps]
        reward = np.asarray([(np.asarray(o) % 2 == 0).mean() for _, o in pairs], np.float32)
        return _pad(pairs, reward - reward.mean(), dtype)
    return make_batch


def _prompt_fn(request_cls=Request):
    def fn(i):
        r = np.random.RandomState(1234 + i)
        return request_cls(prompt=r.randint(0, 256, size=(PROMPT,)).astype(np.int32),
                           max_new_tokens=NEW)
    return fn


def _serving(slots=8):
    return ServingConfig(slots=slots, prefill_chunk=PROMPT)


# ---------------------------------------------------------------------------
# pure pieces
# ---------------------------------------------------------------------------

def test_experience_state_roundtrip():
    e = Experience(index=3, prompt=[1, 2], output=[4, 5, 6], weight_generation=2)
    back = Experience.from_state(e.to_state())
    assert back == e and back.tokens == [1, 2, 4, 5, 6]


def test_rollout_config_requires_divisible_total():
    with pytest.raises(AssertionError, match="multiple"):
        RolloutConfig(train_batch_size=4, total_rollouts=10)


# ---------------------------------------------------------------------------
# the loop end to end, against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_loop(tree):
    set_topology(None)
    engine, *_ = deepspeed_tpu.initialize(
        model=JaxGPT2(jax_config("test", **MODEL)), model_parameters=tree,
        topology=MeshTopology(data=1, devices=jax.devices()[:1]), config=_config(),
        loss_fn=_jax_loss_fn)
    engine.initialize_state(_pad([(np.zeros(PROMPT, np.int32), np.zeros(0, np.int32))] * 8,
                                 np.zeros(8, np.float32), np.int32))
    seen = []
    loop = JaxRolloutLoop(engine, _prompt_fn(JaxRequest), _batcher(seen, np.int32),
                          JaxRolloutConfig(train_batch_size=8, total_rollouts=16, sync_every=1),
                          serving_config=JaxServingConfig(slots=8, prefill_chunk=PROMPT))
    res = loop.run(max_ticks=10**5)
    set_topology(None)
    return res, seen


def test_loop_end_to_end_matches_jax(tree, jax_loop, tmp_path):
    jax_res, jax_seen = jax_loop
    engine = _engine(tree)
    telem = RuntimeTelemetry(TelemetryConfig(enabled=True, output_path=str(tmp_path),
                                             job_name="rlhf"))
    seen = []
    loop = RolloutLoop(engine, _prompt_fn(), _batcher(seen),
                       RolloutConfig(train_batch_size=8, total_rollouts=16, sync_every=1),
                       serving_config=_serving(), telemetry=telem)
    res = loop.run(max_ticks=10**5)
    assert res["exit_code"] == 0 and res["learner_steps"] == 2
    assert res["experience_consumed"] == 16 and res["experience_banked"] == 0
    assert seen == jax_seen, "the banked experience differs from JAX's"
    np.testing.assert_allclose([r["loss"] for r in res["losses"]],
                               [r["loss"] for r in jax_res["losses"]], rtol=0, atol=PARITY_ATOL)
    assert [r["step"] for r in res["losses"]] == [r["step"] for r in jax_res["losses"]]
    assert res["weight_sync_generation"] == jax_res["weight_sync_generation"] == 2
    assert len(res["sync_evidence"]) == 2
    for ev in res["sync_evidence"]:
        assert ev["gather_bytes"] == 0 and ev["total_bytes"] > 0 and ev["digest"]
        assert set(jax_res["sync_evidence"][0]) <= set(ev)  # JAX's evidence keys, all there
    stats = res["scheduler_stats"]["rollout"]
    assert stats["experience"] == 16 and stats["weight_sync_generation"] == 2
    assert stats["last_weight_sync"]["digest_verified"] is True
    sig = loop.scheduler.signals()
    validate_event(dict(sig, tick=0, kind="decode"), kind="serve_tick")
    assert sig["rollout_experience"] == 16
    telem.close()
    events = [r for r in iter_serve_events(os.path.join(telem.run_dir, TELEMETRY_FILE))
              if r["event"] == "rlhf_weight_sync"]
    assert [r["generation"] for r in events] == [1, 2]
    for rec in events:
        validate_event(rec)
        assert rec["digest_verified"] is True
    with pytest.raises(ValueError, match="digest_verified"):
        validate_event({k: v for k, v in events[0].items() if k != "digest_verified"})


# ---------------------------------------------------------------------------
# hot swap between ticks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_dtype", [None, "int8"])
def test_hot_swap_identical_params_mid_decode_is_bit_exact(tree, weight_dtype):
    engine = _engine(tree)
    engine.train_batch(_batcher([])([Experience(i, [1] * PROMPT, [2] * NEW, 0) for i in range(8)]))

    def outputs(mid_swap):
        sched = engine.rollout_scheduler(ServingConfig(slots=2, prefill_chunk=PROMPT,
                                                       weight_dtype=weight_dtype))
        for i in range(2):
            sched.submit(_prompt_fn()(i))
        for _ in range(4):   # prefill + a few decode ticks
            sched.step()
        if mid_swap:
            ev = engine.sync_rollout_weights(sched)
            assert sched.last_weight_sync["digest_verified"] is (weight_dtype is None)
            assert ev["generation"] == sched.weight_sync_generation
        sched.run_until_drained(max_ticks=10**5)
        return [list(map(int, r.output)) for r in sched.finished]

    assert outputs(mid_swap=False) == outputs(mid_swap=True)


def test_swap_refuses_drift_and_digest_mismatch(tree):
    engine = _engine(tree)
    sched = engine.rollout_scheduler(_serving(slots=2))
    good = engine._infer_engine.params
    truncated = {k: v[..., :1] for k, v in good.items()}
    with pytest.raises(ValueError, match="drift"):
        sched.swap_served_params(truncated)
    with pytest.raises(ValueError, match="drift"):
        sched.swap_served_params({k: v for k, v in good.items() if k != "wpe"})
    with pytest.raises(ValueError, match="digest"):
        sched.swap_served_params(good, expected_digest="0" * 64)
    q_sched = engine.rollout_scheduler(ServingConfig(slots=2, prefill_chunk=PROMPT,
                                                     weight_dtype="int8"))
    with pytest.raises(ValueError, match="quantized"):
        q_sched.swap_served_params(good, expected_digest="0" * 64)
    assert sched.weight_sync_generation == 0 and q_sched.weight_sync_generation == 0


def test_swap_places_into_own_tensors_and_hashes_only_what_it_checks(tree, monkeypatch):
    """On fp weights the rollout scheduler serves the view's own tensors: a
    sync places nothing and the learner's digest stands, hashed once. A
    scheduler over an engine of its own (weights zeroed) takes the view's
    weights by a copy, re-digests them, and serves the view's tokens.
    Under int8 the view is not digested at all."""
    from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler
    from deepspeed_tpu_torch.runtime.rlhf import sync

    hashed = []
    real_digest = sync.params_digest
    monkeypatch.setattr(sync, "params_digest", lambda p: hashed.append(1) or real_digest(p))
    engine = _engine(tree)
    engine.train_batch(_batcher([])([Experience(i, [1] * PROMPT, [2] * NEW, 0) for i in range(8)]))

    def served(sched):
        for i in range(2):
            sched.submit(_prompt_fn()(i))
        sched.run_until_drained(max_ticks=10**5)
        return [list(map(int, r.output)) for r in sched.finished]

    view_sched = engine.rollout_scheduler(_serving(slots=2))
    ev = engine.sync_rollout_weights(view_sched)
    assert len(hashed) == 1 and ev["digest"]
    assert view_sched.last_weight_sync["digest_verified"] is True
    assert view_sched.last_weight_sync["placed"] is False
    want = served(view_sched)

    apart = deepspeed_tpu_torch.init_inference(engine.module, dtype=torch.float32,
                                               replace_with_kernel_inject=False,
                                               max_tokens=PROMPT + NEW, device="cpu")
    with torch.no_grad():
        for t in apart.module.state_dict().values():
            t.zero_()
    sched = ContinuousBatchingScheduler(apart, _serving(slots=2))
    with pytest.raises(ValueError, match="digest mismatch"):
        sched.swap_served_params(engine._infer_engine.params, expected_digest="0" * 64, evidence=ev)
    sched.swap_served_params(engine._infer_engine.params, expected_digest=ev["digest"], evidence=ev)
    assert len(hashed) == 3
    assert sched.last_weight_sync["placed"] is True and sched.last_weight_sync["digest_verified"]
    assert served(sched) == want

    q_sched = engine.rollout_scheduler(ServingConfig(slots=2, prefill_chunk=PROMPT,
                                                     weight_dtype="int8"))
    q_ev = engine.sync_rollout_weights(q_sched)
    assert len(hashed) == 3 and "digest" not in q_ev
    assert q_sched.last_weight_sync["digest_verified"] is False


def test_swap_invalidates_the_prefix_cache(tree):
    """KV rows computed under the old weights are never restored after a
    swap: a prompt served again after a sync prefills from scratch, and one
    served again without a sync reuses its cached prefix."""
    engine = _engine(tree)
    prompt = np.arange(PROMPT, dtype=np.int32)   # two full 4-token blocks

    def served_twice(sync_between):
        sched = engine.rollout_scheduler(ServingConfig(slots=2, prefill_chunk=PROMPT, page_size=4))
        first = sched.submit(Request(prompt=prompt, max_new_tokens=NEW))
        sched.run_until_drained(max_ticks=10**5)
        if sync_between:
            engine.train_batch(_batcher([])([Experience(i, [1] * PROMPT, [2] * NEW, 0)
                                             for i in range(8)]))
            engine.sync_rollout_weights(sched)
        again = sched.submit(Request(prompt=prompt, max_new_tokens=NEW))
        sched.run_until_drained(max_ticks=10**5)
        return first, again

    _, again = served_twice(False)
    assert again.cached_prefix_tokens > 0
    first, again = served_twice(True)
    assert first.cached_prefix_tokens == 0 and again.cached_prefix_tokens == 0


# ---------------------------------------------------------------------------
# LoRA fuse -> rollout -> unfuse -> train
# ---------------------------------------------------------------------------

def test_lora_fuse_rollout_unfuse_train_bit_identical(tree):
    def run(with_rollout):
        engine = _engine(tree, n_layer=2)
        b = _pad([(np.arange(PROMPT) % 256, np.full(4, 7))] * 8,
                 np.linspace(-1, 1, 8).astype(np.float32))
        losses = [float(engine.train_batch(b))]
        if with_rollout:
            engine.fuse_lora_weight()
            sched = engine.rollout_scheduler(_serving(slots=2))
            for i in range(2):
                sched.submit(_prompt_fn()(i))
            sched.run_until_drained(max_ticks=10**5)
            assert len(sched.finished) == 2
            engine.unfuse_lora_weight()
        for _ in range(2):
            losses.append(float(engine.train_batch(b)))
        return losses

    assert run(False) == run(True), "the rollout excursion perturbed training"


# ---------------------------------------------------------------------------
# preempt -> drain -> checkpoint -> resume
# ---------------------------------------------------------------------------

def _aligned(**kwargs):
    return RolloutConfig(train_batch_size=8, total_rollouts=24, sync_every=1,
                         align_cohorts=True, **kwargs)


def test_preempt_drains_checkpoints_and_resumes(tree, tmp_path):
    ckpt = str(tmp_path / "rlhf")
    reference = RolloutLoop(_engine(tree), _prompt_fn(), _batcher([]), _aligned(),
                            serving_config=_serving()).run(max_ticks=10**5)
    assert reference["exit_code"] == 0 and reference["learner_steps"] == 3

    engine = _engine(tree)
    guard = PreemptionGuard(signals=[])          # flag-only trigger
    loop = RolloutLoop(engine, _prompt_fn(), _batcher([]), _aligned(checkpoint_dir=ckpt),
                       serving_config=_serving())
    orig = engine.train_batch

    def train_then_flag(batch):
        loss = orig(batch)
        guard.request("test-preempt")
        return loss

    engine.train_batch = train_then_flag
    res = loop.run(guard=guard, max_ticks=10**5)
    assert res["exit_code"] == 143 and res["preempted"] == "test-preempt"
    assert res["learner_steps"] == 1 and res["dropped"] == 0
    assert res["checkpoint_tag"] == "global_step1"
    first = res["losses"]

    fresh = _engine(tree)
    tag, client_state = fresh.resume(ckpt)
    assert tag == "global_step1"
    loop2 = RolloutLoop(fresh, _prompt_fn(), _batcher([]), _aligned(),
                        serving_config=_serving())
    assert loop2.restore(client_state)
    assert loop2.learner_steps == 1 and loop2.consumed == 8
    res2 = loop2.run(max_ticks=10**5)
    assert res2["exit_code"] == 0 and res2["learner_steps"] == 3
    assert res2["experience_consumed"] == 24
    assert {r["step"] for r in first}.isdisjoint(r["step"] for r in res2["losses"])
    stitched = [r["loss"] for r in first + res2["losses"]]
    assert stitched == [r["loss"] for r in reference["losses"]]
