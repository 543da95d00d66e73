"""The port's training-engine resilience against the JAX package.

On the same inputs the port's pure-Python pieces give what JAX's give:
``OverflowWatcher`` (events, streaks, the abort), ``parse_fault_spec``,
``RetryPolicy`` (delays, evidence, the classifier), ``bitflip_file`` and
``truncate_file`` (the same bytes damaged), ``corrupt_checkpoint`` (the same
victim), ``compute_elastic_config`` over a grid of configs and world sizes,
``list_checkpoint_tags(with_meta=True)`` and ``decide_resume``, and the
config's ``resilience``, ``nebula`` and ``elasticity`` blocks (every field's
default and bound; the batch triangle at world size 1). Then the engine on
GPT-2 "test" (2 layers, fp32, CPU): poisoned batches abort at the same step
as the JAX engine's, SIGTERM checkpoints at the next boundary and raises
``SystemExit(143)`` (``tests/unit/resilience/test_fault_matrix.py:226-290``),
and ``resume()`` continues bit for bit; the heartbeat. Exact comparisons
throughout (tolerance 0): the losses of a resumed run are bit-equal.
"""

import json
import os
import shutil
import signal
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.elasticity import elasticity as jax_elasticity
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_gpt2_config
from deepspeed_tpu.runtime import config as jax_config
from deepspeed_tpu.runtime.elastic import agent as jax_agent
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_scaler
from deepspeed_tpu.runtime.resilience import faults as jax_faults
from deepspeed_tpu.runtime.resilience import manifest as jax_manifest
from deepspeed_tpu.runtime.resilience import retry as jax_retry
import deepspeed_tpu_torch
from deepspeed_tpu_torch.elasticity import elasticity, elastic_agent
from deepspeed_tpu_torch.runtime import config as port_config
from deepspeed_tpu_torch.runtime.elastic import agent
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler
from deepspeed_tpu_torch.runtime.resilience import faults, manifest, retry
from deepspeed_tpu_torch.runtime.resilience.signals import PreemptionGuard


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def _restore_signals():
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in prev.items():
        signal.signal(s, h)


def _outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("raises", exception class name)``."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 (compared by class name)
        return ("raises", type(e).__name__)


# ---------------------------------------------------------------------------
# the pure-Python pieces, side by side
# ---------------------------------------------------------------------------

def test_overflow_watcher_matches_jax():
    rng = np.random.default_rng(0)
    flags = rng.random(200) < 0.45
    scales = np.cumprod(np.where(flags, 0.5, 1.0)) * 2.0 ** 16
    for abort_after in (0, 3, 5):
        runs = []
        for cls in (jax_scaler.OverflowWatcher, loss_scaler.OverflowWatcher):
            w, events, abort = cls(abort_after=abort_after), [], None
            for step, (ov, ls) in enumerate(zip(flags, scales), start=1):
                try:
                    events.append(w.record(step, bool(ov), ls if step % 3 else None))
                except RuntimeError as e:
                    abort = (step, str(e))
                    break
            runs.append((events, abort, w.consecutive, w.longest_streak, w.total_skipped))
        assert runs[0] == runs[1]
        assert (runs[1][1] is None) == (abort_after == 0)
    assert issubclass(loss_scaler.OverflowAbort, RuntimeError)


@pytest.mark.parametrize("raw", ["", "step=sigkill@3", "ckpt_pre_rename=sigkill",
                                 " step = hang @ 2 , ckpt_pre_rename=exit1", "step=", "=x",
                                 "step", "a=b@c,a=d"])
def test_parse_fault_spec_matches_jax(raw):
    assert _outcome(faults.parse_fault_spec, raw) == _outcome(jax_faults.parse_fault_spec, raw)


def test_fault_point_is_armed_only_by_the_spec(monkeypatch):
    monkeypatch.delenv(faults.FAULT_ENV, raising=False)
    faults.fault_point("step", step=3)  # unarmed: nothing
    monkeypatch.setenv(faults.FAULT_ENV, "step=bogus@3")
    faults.fault_point("step", step=2)  # another step: nothing
    faults.fault_point("other")
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.fault_point("step", step=3)


def test_retry_policy_and_classifier_match_jax():
    errors = [jax_faults.make_compile_helper_500(), ConnectionError("Connection reset by peer"),
              RuntimeError("CheckpointCorruptError: sha256 mismatch"), ValueError("plain"),
              OSError("Resource temporarily unavailable")]
    for e in errors:
        assert retry.classify_failure(e) == jax_retry.classify_failure(e)
        assert retry.is_transient(e) == jax_retry.is_transient(e)
    assert faults.make_compile_helper_500().args == jax_faults.make_compile_helper_500().args
    for fails, attempts in ((0, 3), (2, 3), (3, 3), (4, 6)):
        runs = []
        for mod, fmod in ((jax_retry, jax_faults), (retry, faults)):
            slept = []
            flaky = fmod.FlakyCall(lambda: "banked", fails=fails)
            policy = mod.RetryPolicy(max_attempts=attempts, base_delay=0.5, max_delay=3.0,
                                     jitter=0.25, seed=7, sleep=slept.append)
            result = _outcome(policy.call, flaky)
            runs.append((result, slept, policy.evidence(), flaky.calls,
                         [policy.delay_for(n) for n in range(1, 6)]))
        assert runs[0] == runs[1]
    # a non-transient error propagates at its first attempt
    policy = retry.RetryPolicy(max_attempts=5, sleep=lambda s: pytest.fail("slept"))
    with pytest.raises(ValueError):
        policy.call(faults.FlakyCall(lambda: 1, fails=1, exc_factory=lambda: ValueError("x")))
    assert policy.attempts[0]["error_class"] is None and policy.attempts[0]["delay_s"] == 0.0


def test_heartbeat_sleep_touches_the_heartbeat(tmp_path, monkeypatch):
    hb = tmp_path / "hb"
    monkeypatch.setenv(elastic_agent.HEARTBEAT_ENV, str(hb))
    retry.heartbeat_sleep(slice_s=0.01)(0.03)
    assert elastic_agent.heartbeat_age(str(hb)) < 5.0


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_bitflip_and_truncate_damage_the_same_bytes_as_jax(tmp_path, seed):
    payload = np.random.default_rng(seed).integers(0, 256, 4099).astype(np.uint8).tobytes()
    paths = {}
    for who in ("jax", "port"):
        for what in ("flip", "cut"):
            paths[who, what] = tmp_path / f"{who}_{what}"
            paths[who, what].write_bytes(payload)
    jax_faults.bitflip_file(str(paths["jax", "flip"]), seed=seed)
    faults.bitflip_file(str(paths["port", "flip"]), seed=seed)
    jax_faults.truncate_file(str(paths["jax", "cut"]), keep_fraction=0.3 + 0.1 * seed)
    faults.truncate_file(str(paths["port", "cut"]), keep_fraction=0.3 + 0.1 * seed)
    for what in ("flip", "cut"):
        assert paths["port", what].read_bytes() == paths["jax", what].read_bytes()
    assert paths["port", "flip"].read_bytes() != payload


# (name, elasticity block, world sizes): v0.1 and v0.2, both batch
# preferences, a host granularity and model parallelism, and sizes outside
# the valid set
ELASTIC_CASES = [
    ("v0.1", dict(max_train_batch_size=2000, micro_batch_sizes=[2, 4, 6], min_gpus=1,
                  max_gpus=10000, version=0.1)),
    ("v0.1 small", dict(max_train_batch_size=8, micro_batch_sizes=[2, 4], min_gpus=1, max_gpus=4,
                        version=0.1)),
    ("v0.1 smaller batch", dict(max_train_batch_size=96, micro_batch_sizes=[3, 8],
                                prefer_larger_batch=False, version=0.1)),
    ("v0.2", dict(max_train_batch_size=2000, micro_batch_sizes=[2, 4, 6], min_gpus=1,
                  max_gpus=10000, version=0.2)),
    ("v0.2 hosts of 4, mp 2", dict(max_train_batch_size=1024, micro_batch_sizes=[1, 2, 4],
                                   num_gpus_per_node=4, model_parallel_size=2, version=0.2)),
    ("v0.2 mp 3 of 4", dict(max_train_batch_size=64, micro_batch_sizes=[2], num_gpus_per_node=4,
                            model_parallel_size=3, version=0.2)),
    ("bad micro", dict(max_train_batch_size=8, micro_batch_sizes=[0, 2])),
    ("no max", dict(micro_batch_sizes=[2])),
    ("bad version", dict(max_train_batch_size=8, micro_batch_sizes=[2], version=0.3)),
]


@pytest.mark.parametrize("name,block", ELASTIC_CASES, ids=[c[0] for c in ELASTIC_CASES])
def test_compute_elastic_config_matches_jax(name, block):
    ds = {"elasticity": dict(block, enabled=True)}
    for world in (0, 1, 2, 3, 4, 8, 12, 16, 250):
        for micro in (False, True):
            kw = dict(world_size=world, return_microbatch=micro)
            assert (_outcome(elasticity.compute_elastic_config, ds, "0.1.0", **kw)
                    == _outcome(jax_elasticity.compute_elastic_config, ds, "0.1.0", **kw)), kw
    assert elasticity.elasticity_enabled(ds) == jax_elasticity.elasticity_enabled(ds)
    with pytest.raises(elasticity.ElasticityConfigError):
        elasticity.compute_elastic_config({"elasticity": dict(block, enabled=False)})


def _stamped_tags(root, entries):
    """Tag dirs with only the stamp a supervisor reads: ``{name: (metadata
    or raw text, mtime)}``."""
    for name, (meta, mtime) in entries.items():
        tag = root / name
        (tag / "state").mkdir(parents=True)
        (tag / "metadata.json").write_text(meta if isinstance(meta, str) else json.dumps(meta))
        os.utime(tag, (mtime, mtime))


def test_tag_listing_and_resume_decisions_match_jax(tmp_path):
    assert agent.decide_resume(str(tmp_path / "none"), 1) == jax_agent.decide_resume(
        str(tmp_path / "none"), 1)
    _stamped_tags(tmp_path, {
        "global_step1": ({"global_steps": 1, "world_size": 1}, 100),
        "global_step3": ({"global_steps": 3, "world_size": 1}, 90),
        "sharded": ({"global_steps": 2, "world_size": 4, "mesh_axes": {"data": 1, "fsdp": 4}}, 95),
        "garbled": ("{not json", 99),
        "bad_stamp": ({"global_steps": "x", "world_size": "four"}, 98),
        "old": ({"global_steps": 0}, 50),
    })
    (tmp_path / ".tmp.global_step5").mkdir()
    for with_meta in (False, True):
        assert (manifest.list_checkpoint_tags(str(tmp_path), with_meta=with_meta)
                == jax_manifest.list_checkpoint_tags(str(tmp_path), with_meta=with_meta))
    for marker in (None, "sharded", "old", "missing"):
        if marker is not None:
            (tmp_path / "latest").write_text(marker)
        for world, axes in ((1, None), (4, None), (4, {"data": 2, "fsdp": 2}), (1, {"data": 1})):
            assert (agent.decide_resume(str(tmp_path), world, target_axes=axes)
                    == jax_agent.decide_resume(str(tmp_path), world, target_axes=axes))
        assert (agent.checkpoint_topology(str(tmp_path))
                == jax_agent.checkpoint_topology(str(tmp_path)))
    assert agent.decide_resume(str(tmp_path), 1)["resume"] == "plain"  # the newest: global_step3
    (tmp_path / "latest").write_text("old")
    assert agent.decide_resume(str(tmp_path), 1)["resume"] == "unknown"  # no world size stamped


# (field, values) of the resilience and nebula blocks: defaults, bounds,
# conversions and refusals
RESILIENCE_VALUES = {
    "verify_checkpoint": ["off", "files", "full", "FULL", "some", 1, "auto"],
    "fallback_on_corruption": [True, False, 0, 1, 2, "yes", "off", "maybe", None],
    "max_consecutive_overflows": [0, 3, -1, 2.0, 2.5, "4", "x", True, None],
    "heartbeat_interval": [0, 0.5, 2, -0.1, "1.5", True, None, "auto"],
    "preempt_save_dir": [None, "/tmp/x", 3],
    "preempt_signals": [["SIGTERM"], ("SIGINT", "SIGTERM"), "SIGTERM", None],
    "exit_after_preempt_save": [True, False, "no", 2],
    "preempt_exit_code": [143, 0, "7", None, 1.0],
    "bogus_key": [1],
}
NEBULA_VALUES = {
    "enabled": [True, False, "true", 3],
    "persistent_storage_path": [None, "/tmp/n", 5],
    "persistent_time_interval": [None, 100, "5", 1.5],
    "num_of_version_in_retention": [2, -1, "3", None],
    "enable_nebula_load": [True, "false", None],
    "load_path": [None, "/tmp/l", 1],
    "bogus_key": [1],
}


def _block_outcome(cls, attrs, **kw):
    def read():
        block = cls(**kw) if cls.__module__.startswith("deepspeed_tpu.") else cls(kw)
        return {a: getattr(block, a) for a in attrs}
    return _outcome(read)


@pytest.mark.parametrize("block", ["resilience", "nebula"])
def test_resilience_and_nebula_blocks_match_jax(block):
    values = RESILIENCE_VALUES if block == "resilience" else NEBULA_VALUES
    jax_cls = jax_config.ResilienceConfig if block == "resilience" else jax_config.NebulaConfig
    port_cls = port_config.ResilienceConfig if block == "resilience" else port_config.NebulaConfig
    attrs = sorted(port_cls.FIELDS)
    assert attrs == sorted(jax_cls.model_fields)
    # the defaults
    assert _block_outcome(port_cls, attrs) == _block_outcome(jax_cls, attrs)
    for field, vals in values.items():
        for v in vals:
            got, want = _block_outcome(port_cls, attrs, **{field: v}), _block_outcome(
                jax_cls, attrs, **{field: v})
            # pydantic's ValidationError is a ValueError; the port raises ValueError
            if want[0] == "raises":
                assert got == ("raises", "ValueError"), (field, v, got, want)
            else:
                assert got == want, (field, v)
    # through the port's whole config
    cfg = port_config.DeepSpeedConfig({"train_batch_size": 2, block: {}})
    assert getattr(cfg, f"{block}_config").__dict__ == port_cls(None).__dict__


ELASTIC_BLOCK = dict(enabled=True, max_train_batch_size=96, micro_batch_sizes=[2, 3, 4],
                     min_gpus=1, max_gpus=16, version=0.1)


@pytest.mark.parametrize("batch", [
    {}, {"train_batch_size": 8}, {"train_micro_batch_size_per_gpu": 2},
    {"train_batch_size": 8, "gradient_accumulation_steps": 2}])
@pytest.mark.parametrize("ignore", [False, True])
@pytest.mark.parametrize("version", [0.1, 0.2])
def test_elasticity_block_resolves_the_batch_as_jax_at_world_size_1(batch, ignore, version):
    ds = dict(batch, elasticity=dict(ELASTIC_BLOCK, version=version,
                                     ignore_non_elastic_batch_info=ignore))

    def triangle(cfg):
        return (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
                cfg.gradient_accumulation_steps)

    want = _outcome(lambda: triangle(jax_config.DeepSpeedConfig(ds, world_size=1)))
    got = _outcome(lambda: triangle(port_config.DeepSpeedConfig(ds)))
    assert got == want
    assert (got[0] == "raises") == (bool(batch) and not ignore)


# ---------------------------------------------------------------------------
# the engine on GPT-2 "test"
# ---------------------------------------------------------------------------
SEQ = 16


def _ds(**over):
    ds = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "steps_per_print": 1}
    ds.update(over)
    return ds


def _engine(ds=None, loss_fn=None):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test")
    return deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"), config=ds or _ds(),
        loss_fn=loss_fn, device="cpu")[0]


def _batch(step=0):
    return {"input_ids": np.random.default_rng(1000 + step).integers(0, 256, (8, SEQ)).astype(np.int32)}


def _params(engine):
    return [p.detach().clone() for p in engine.module.parameters()]


def _abort_step(engine, guard, snapshot=None):
    """Train a healthy step, then poisoned ones until ``OverflowAbort``:
    returns the poisoned steps taken (the aborting one counted), the
    engine's step then, and ``snapshot()`` taken before the first poisoned
    step."""
    engine.train_batch(_batch())
    before = snapshot() if snapshot else None
    poisoned = (faults if isinstance(engine, deepspeed_tpu_torch.DeepSpeedEngine)
                else jax_faults).poison_batch(_batch())
    for n in range(1, guard + 3):
        try:
            engine.train_batch(poisoned)
        except RuntimeError as e:
            assert type(e).__name__ == "OverflowAbort", e
            return (n, engine.global_steps), before
    return (None, engine.global_steps), before


@pytest.mark.parametrize("guard", [2, 3])
def test_poisoned_batches_abort_at_the_same_step_as_jax(guard):
    ds = _ds(resilience={"max_consecutive_overflows": guard})
    jax_engine, _, _, _ = deepspeed_tpu.initialize(
        model=JaxGPT2(jax_gpt2_config("test")), config=ds,
        loss_fn=jax_faults.overflow_injected_loss())
    want, _ = _abort_step(jax_engine, guard)
    port = _engine(ds, loss_fn=faults.overflow_injected_loss())
    got, before = _abort_step(port, guard, snapshot=lambda: _params(port))
    assert got == want == (guard, guard + 1)
    assert port.skipped_steps == guard
    assert all(torch.equal(a, b) for a, b in zip(before, _params(port)))
    # the port's poison leaf is a [B] float32 array, as JAX's
    leaf = faults.poison_batch(_batch(), boost=4.0)[faults.FAULT_BOOST_KEY]
    np.testing.assert_array_equal(leaf, jax_faults.poison_batch(_batch(), boost=4.0)[
        jax_faults.FAULT_BOOST_KEY])
    # a finite boost only scales the loss: no skip, no abort
    scaled = _engine(ds, loss_fn=faults.overflow_injected_loss())
    for _ in range(guard + 1):
        assert np.isfinite(float(scaled.train_batch(faults.poison_batch(_batch(), boost=2.0))))
    assert scaled.skipped_steps == 0


def test_sigterm_checkpoints_at_the_next_boundary_and_resumes_bit_equal(tmp_path, _restore_signals):
    """SIGTERM sets a flag only; the next boundary saves, and with
    ``exit_after_save`` raises ``SystemExit(143)``; ``resume()`` with no dir
    then continues to the uninterrupted run's losses, bit for bit."""
    reference = _engine()
    want = [float(reference.train_batch(_batch(s))) for s in range(4)]

    ckpt = str(tmp_path / "preempt")
    engine = _engine()
    guard = engine.enable_preemption_checkpoint(ckpt, exit_after_save=False)
    losses = [float(engine.train_batch(_batch(0)))]
    assert not os.path.exists(ckpt)  # nothing saved without a signal
    os.kill(os.getpid(), signal.SIGTERM)
    assert guard.requested and not os.path.exists(ckpt)  # the handler only flags
    losses.append(float(engine.train_batch(_batch(1))))
    assert not guard.requested
    assert open(os.path.join(ckpt, "latest")).read() == "global_step2"

    engine.enable_preemption_checkpoint(ckpt, exit_after_save=True)
    os.kill(os.getpid(), signal.SIGTERM)
    with pytest.raises(SystemExit) as e:
        engine.train_batch(_batch(2))
    assert e.value.code == 143
    assert open(os.path.join(ckpt, "latest")).read() == "global_step3"  # durable before the exit

    fresh = _engine(_ds(resilience={"preempt_save_dir": ckpt, "exit_after_preempt_save": False}))
    assert fresh._preemption is not None and fresh._preemption.installed  # armed at init
    assert fresh.resume() == ("global_step3", {}) and fresh.global_steps == 3
    losses.append(float(fresh.train_batch(_batch(3))))
    assert losses == [want[0], want[1], want[3]]
    assert all(torch.equal(a, b) for a, b in zip(_params(fresh), _params(reference)))
    # a requested preemption through the config-armed guard saves without exiting
    fresh._preemption.request("test")
    fresh.train_batch(_batch(4))
    assert open(os.path.join(ckpt, "latest")).read() == "global_step5"
    with pytest.raises(ValueError, match="load_dir"):
        _engine().resume()


def test_second_sigint_escalates_to_keyboard_interrupt(_restore_signals):
    guard = PreemptionGuard(signals=["SIGINT"]).install()
    try:
        os.kill(os.getpid(), signal.SIGINT)
        time.sleep(0.01)
        assert guard.requested  # the first Ctrl-C: a flag only
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.5)
        assert not guard.installed  # the escalation restored the handlers
    finally:
        guard.uninstall()


@pytest.mark.parametrize("interval", [0.0, 3600.0])
def test_heartbeat_is_written_each_step_with_global_step(tmp_path, monkeypatch, interval):
    hb = tmp_path / f"hb{interval}"
    monkeypatch.setenv(elastic_agent.HEARTBEAT_ENV, str(hb))
    engine = _engine(_ds(resilience={"heartbeat_interval": interval}))
    assert not hb.exists()  # no step, no heartbeat
    for s in range(3):
        engine.train_batch(_batch(s))
        beat = elastic_agent.read_heartbeat(str(hb))
        # throttled: at 3600 s only the first step's touch lands
        assert beat["global_step"] == (s + 1 if interval == 0.0 else 1)
        assert beat["pid"] == os.getpid() and beat["world_size"] == 1
        assert beat["last_span"] is None and beat["mesh_axes"] is None
    assert elastic_agent.heartbeat_age(str(hb)) < 60.0
    monkeypatch.delenv(elastic_agent.HEARTBEAT_ENV)
    assert elastic_agent.heartbeat_age() is None


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_checkpoint_picks_jaxs_victim_and_falls_back(tmp_path, mode):
    engine = _engine()
    for s in range(2):
        engine.train_batch(_batch(s))
        engine.save_checkpoint(str(tmp_path / "port"), tag=f"t{s + 1}")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    victim = faults.corrupt_checkpoint(str(tmp_path / "port"), "t2", mode=mode, seed=3)
    jax_victim = jax_faults.corrupt_checkpoint(str(tmp_path / "jax"), "t2", mode=mode, seed=3)
    assert os.path.relpath(victim, tmp_path / "port") == os.path.relpath(jax_victim, tmp_path / "jax")
    assert victim.endswith(os.path.join("state", "optimizer.pt"))  # the largest state file
    assert open(victim, "rb").read() == open(jax_victim, "rb").read()
    fresh = _engine()
    assert fresh.resume(str(tmp_path / "port")) == ("t1", {}) and fresh.global_steps == 1
