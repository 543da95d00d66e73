"""The port's checkpoints against the JAX package's contract.

The applicable cases of ``tests/unit/checkpoint/test_checkpoint.py`` and
``tests/unit/resilience/test_manifest.py``, on GPT-2 "test" (2 layers, 64
wide, seq 16, fp32) through the port's engine: a save and load round trip
(parameters, Adam moments and count, counters, ``client_state``, the
generator), a resume bit for bit equal to the uninterrupted run with a
scheduler, with dropout and with MoE RTS, tags and ``latest``,
``load_module_only`` and ``load_optimizer_states=False``, corrupt tags
(truncated, bit-flipped, a leaf digest) falling back only to older intact
tags, staging dirs, ``resume`` without a marker, the refused options. The
manifest functions run beside the JAX package's on the same files. The
16-bit model file is read by the JAX package's own
``load_state_dict_from_npz``. No JAX engine runs here.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import flax
import jax
import ml_dtypes
import torch

from deepspeed_tpu.checkpoint.zero_to_fp32 import _flatten, load_state_dict_from_npz
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.runtime.resilience import manifest as jax_manifest
from deepspeed_tpu.runtime.resilience.faults import bitflip_file, corrupt_checkpoint, truncate_file
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.moe import routing
from deepspeed_tpu_torch.runtime.resilience import manifest
from deepspeed_tpu_torch.runtime.resilience.manifest import CheckpointCorruptError

MODEL = dict(n_layer=2, n_embd=64, n_head=4, n_positions=16)
MOE = dict(moe_num_experts=4, moe_layer_freq=2, moe_k=1, moe_use_rts=True)


def _config(**over):
    cfg = {"train_batch_size": 8, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "steps_per_print": 10**9}
    cfg.update(over)
    return cfg


def _engine(config=None, **model):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **dict(MODEL, **model))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"),
        config=config or _config(), device="cpu")
    return engine


def _batch(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (8, 16)).astype(np.int32)


def _state(engine):
    """Every tensor a checkpoint holds, copied."""
    return {k: v.detach().clone() for k, v in engine.checkpoint_state().items()}


def _assert_state_equal(a, b, groups=("module", "optimizer", "rng")):
    sa, sb = _state(a), _state(b)
    assert set(sa) == set(sb)
    for k in sa:
        if k.split("/")[0] in groups:
            assert torch.equal(sa[k], sb[k]), k


def _counters(engine):
    return (engine.global_steps, engine.global_samples, engine.micro_steps, engine.skipped_steps)


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


def test_checkpoint_roundtrip(tmp_path):
    e1 = _engine(_config(gradient_accumulation_steps=2), dropout=0.1)
    for s in range(2):
        e1.train_batch(_batch(s))
    e1.save_checkpoint(str(tmp_path), client_state={"note": "hello", "epoch": 3})
    assert open(tmp_path / "latest").read() == "global_step2"
    tag_dir = tmp_path / "global_step2"
    assert sorted(os.listdir(tag_dir)) == ["manifest.json", "metadata.json", "state"]
    assert sorted(os.listdir(tag_dir / "state")) == ["module.pt", "optimizer.pt", "rng.pt"]
    man = json.loads((tag_dir / "manifest.json").read_text())
    assert set(man) == {"version", "files", "leaves"} and set(man["leaves"]) == set(_state(e1))

    e2 = _engine(_config(gradient_accumulation_steps=2), dropout=0.1)
    params = [p for p in e2.module.parameters()]
    moments = [e2.optimizer.state[p]["exp_avg"] for p in params]
    path, client = e2.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path) and client == {"note": "hello", "epoch": 3}
    assert _counters(e2) == _counters(e1) == (2, 16, 4, 0)
    assert e2.optimizer.count == e1.optimizer.count == 2
    _assert_state_equal(e1, e2)
    # in place: the same parameter and moment objects, the grads still views
    assert all(p is q for p, q in zip(params, e2.module.parameters()))
    assert all(m is e2.optimizer.state[p]["exp_avg"] for m, p in zip(moments, params))
    assert torch.equal(e1.train_batch(_batch(5)), e2.train_batch(_batch(5)))
    _assert_state_equal(e1, e2)


@pytest.mark.parametrize("variant", ["scheduler", "dropout", "moe-rts"])
def test_resume_is_bit_exact(tmp_path, variant):
    """Train 2 + 3 steps without a break, and 2, save, load into a fresh
    engine, 3: the losses, the learning rates and the final state agree in
    every bit (the Adam state, the step counters the schedule reads, and
    the generator that dropout and the RTS draws come from)."""
    config, model = _config(), {}
    if variant == "scheduler":
        config = _config(scheduler={"type": "WarmupLR", "params": {
            "warmup_min_lr": 0.0, "warmup_max_lr": 1e-3, "warmup_num_steps": 4}})
    elif variant == "dropout":
        model = dict(dropout=0.1)
    else:
        model = dict(MOE, dropout=0.1)
    e1 = _engine(config, **model)
    losses, lrs = [], []
    for s in range(5):
        losses.append(e1.train_batch(_batch(s)))
        lrs.append(e1.get_lr()[0])
        if s == 1:
            e1.save_checkpoint(str(tmp_path), tag="mid")
    e2 = _engine(config, **model)
    e2.load_checkpoint(str(tmp_path), tag="mid")
    assert e2.global_steps == 2
    for s in range(2, 5):
        assert torch.equal(e2.train_batch(_batch(s)), losses[s]), s
        assert e2.get_lr()[0] == lrs[s]
    _assert_state_equal(e1, e2)
    # the generator mattered: without it the resumed curve parts
    e3 = _engine(config, **model)
    e3.load_checkpoint(str(tmp_path), tag="mid")
    e3.generator.manual_seed(99)
    if variant != "scheduler":
        assert not torch.equal(e3.train_batch(_batch(2)), losses[2])


def test_save_inside_an_accumulation_window_is_refused(tmp_path):
    """A checkpoint holds no half-summed gradients, so a save mid-window
    raises and writes nothing. Saved after the window's step, it resumes
    bit for bit; a resume whose ``micro_steps`` sit off this engine's
    window (another ``gas``) makes ``train_batch`` raise instead of
    skipping the optimizer step."""
    config = _config(gradient_accumulation_steps=2)
    e1 = _engine(config, dropout=0.1)
    e1.train_batch(_batch(0))
    micro = [{"input_ids": _batch(1)[i * 4:(i + 1) * 4]} for i in range(2)]
    e1.backward(e1.forward(micro[0]))
    with pytest.raises(RuntimeError, match="accumulation window"):
        e1.save_checkpoint(str(tmp_path), tag="mid")
    assert os.listdir(tmp_path) == []
    e1.backward(e1.forward(micro[1]))
    e1.step()
    e1.save_checkpoint(str(tmp_path), tag="mid")
    want = e1.train_batch(_batch(2))
    e2 = _engine(config, dropout=0.1)
    e2.load_checkpoint(str(tmp_path), tag="mid")
    assert _counters(e2) == (2, 16, 4, 0)
    assert torch.equal(e2.train_batch(_batch(2)), want)
    _assert_state_equal(e1, e2)
    e8 = _engine(_config(gradient_accumulation_steps=8))
    e8.load_checkpoint(str(tmp_path), tag="mid")
    before = _state(e8)
    with pytest.raises(RuntimeError, match="accumulation window"):
        e8.train_batch(_batch(2))
    assert e8.micro_steps == 4 and all(torch.equal(v, before[k]) for k, v in _state(e8).items())


def test_multiple_tags_and_latest(tmp_path):
    e = _engine()
    e.train_batch(_batch(0))
    e.save_checkpoint(str(tmp_path), tag="step1")
    w1 = e.module.wte.detach().clone()
    e.train_batch(_batch(1))
    e.save_checkpoint(str(tmp_path), tag="step2")
    w2 = e.module.wte.detach().clone()
    assert manifest.list_checkpoint_tags(str(tmp_path)) == ["step2", "step1"]
    latest = _engine()
    latest.load_checkpoint(str(tmp_path))
    assert torch.equal(latest.module.wte, w2) and latest.loaded_checkpoint_tag == "step2"
    older = _engine()
    older.load_checkpoint(str(tmp_path), tag="step1")
    assert torch.equal(older.module.wte, w1) and older.global_steps == 1


def test_load_module_only_and_without_optimizer_states(tmp_path):
    e1 = _engine(dropout=0.1)
    e1.train_batch(_batch(0))
    e1.save_checkpoint(str(tmp_path))
    fresh = _engine(dropout=0.1)
    before = _state(fresh)

    only = _engine(dropout=0.1)
    only.load_checkpoint(str(tmp_path), load_module_only=True)
    _assert_state_equal(only, e1, groups=("module",))
    got = _state(only)
    for k in before:
        if not k.startswith("module/"):
            assert torch.equal(got[k], before[k]), k  # optimizer and generator kept
    assert only.optimizer.count == 0 and only.global_steps == 1  # counters, as in JAX

    no_opt = _engine(dropout=0.1)
    no_opt.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    _assert_state_equal(no_opt, e1, groups=("module", "rng"))
    got = _state(no_opt)
    assert all(torch.equal(got[k], before[k]) for k in before if k.startswith("optimizer/"))
    assert no_opt.optimizer.count == 0 and no_opt.global_steps == 1


def test_missing_latest_returns_none(tmp_path):
    e = _engine()
    assert e.load_checkpoint(str(tmp_path)) == (None, {})
    assert e.resume(str(tmp_path)) == (None, {})
    assert e.load_checkpoint(str(tmp_path / "absent")) == (None, {})


def _two_tags(tmp_path, **save):
    e = _engine()
    e.train_batch(_batch(0))
    e.save_checkpoint(str(tmp_path), tag="step1")
    w1 = e.module.wte.detach().clone()
    e.train_batch(_batch(1))
    e.save_checkpoint(str(tmp_path), tag="step2", **save)
    return w1


def _flip_leaf_digest(base, tag):
    """A manifest whose file inventory is intact but one leaf's recorded
    digest differs: only the post-load leaf check can see it."""
    tag_dir = os.path.join(base, tag)
    man = manifest.read_manifest(tag_dir)
    man["leaves"]["module/wte"]["sha256"] = "0" * 64
    manifest.write_manifest(tag_dir, man)


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "leaf-digest"])
def test_corrupt_newest_tag_falls_back_to_the_older_one(tmp_path, damage, caplog):
    w1 = _two_tags(tmp_path)
    if damage == "leaf-digest":
        _flip_leaf_digest(str(tmp_path), "step2")
    else:
        corrupt_checkpoint(str(tmp_path), "step2", mode=damage)
    e = _engine()
    path, _ = e.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path) and e.loaded_checkpoint_tag == "step1"
    assert torch.equal(e.module.wte, w1) and e.global_steps == 1
    assert "step2" in caplog.text and "corrupt" in caplog.text
    # the corrupt tag alone, asked for by name, with nothing older: raises
    strict = _engine(_config(resilience={"fallback_on_corruption": False}))
    with pytest.raises(CheckpointCorruptError):
        strict.load_checkpoint(str(tmp_path), tag="step2")
    assert strict.global_steps == 0


def test_corrupt_tag_never_falls_forward(tmp_path):
    """An explicit request for an older tag that is corrupt must not resolve
    to the newer state the caller is escaping."""
    _two_tags(tmp_path)
    corrupt_checkpoint(str(tmp_path), "step1", mode="bitflip")
    e = _engine()
    with pytest.raises(CheckpointCorruptError, match="no intact checkpoint"):
        e.load_checkpoint(str(tmp_path), tag="step1")
    assert e.global_steps == 0 and e.optimizer.count == 0


def test_verify_modes(tmp_path):
    """``files`` checks the inventory only (a leaf digest goes unseen),
    ``off`` nothing; a truncated file still fails to deserialize."""
    _two_tags(tmp_path)
    _flip_leaf_digest(str(tmp_path), "step2")
    files = _engine(_config(resilience={"verify_checkpoint": "files"}))
    files.load_checkpoint(str(tmp_path))
    assert files.loaded_checkpoint_tag == "step2"
    truncate_file(os.path.join(tmp_path, "step2", "state", "optimizer.pt"))
    off = _engine(_config(resilience={"verify_checkpoint": "off",
                                      "fallback_on_corruption": False}))
    with pytest.raises(CheckpointCorruptError, match="deserialize"):
        off.load_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="verify_checkpoint"):
        _engine(_config(resilience={"verify_checkpoint": "some"}))


def test_stale_staging_is_swept_and_never_listed(tmp_path):
    _two_tags(tmp_path)
    (tmp_path / ".tmp.step3" / "state").mkdir(parents=True)  # a save killed mid-write
    assert manifest.list_checkpoint_tags(str(tmp_path)) == ["step2", "step1"]
    e = _engine()
    assert e.resume(str(tmp_path)) == ("step2", {})
    assert sorted(os.listdir(tmp_path)) == ["latest", "step1", "step2"]
    (tmp_path / ".tmp.other").mkdir()
    e.save_checkpoint(str(tmp_path), tag="step9")
    assert sorted(os.listdir(tmp_path)) == ["latest", "step1", "step2", "step9"]


def test_resume_without_marker_takes_the_newest_intact_tag(tmp_path):
    _two_tags(tmp_path, save_latest=False)
    assert open(tmp_path / "latest").read() == "step1"
    os.remove(tmp_path / "latest")
    e = _engine()
    tag, client = e.resume(str(tmp_path))
    assert (tag, client, e.global_steps) == ("step2", {}, 2)
    corrupt_checkpoint(str(tmp_path), "step2", mode="truncate")
    e = _engine()
    assert e.resume(str(tmp_path)) == ("step1", {})


def test_refused_options_raise_not_implemented(tmp_path):
    e = _engine()
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        e.resume_elastic(str(tmp_path))
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        e.load_universal(str(tmp_path))
    with pytest.raises(NotImplementedError, match="slice"):
        _engine(_config(zero_optimization={"stage": 0, "offload_optimizer": {"device": "cpu"}}))
    _engine(_config(nebula={"enabled": False}))
    with pytest.raises(TypeError, match="JSON serializable"):
        e.save_checkpoint(str(tmp_path), client_state={"step": object()})
    assert manifest.list_checkpoint_tags(str(tmp_path)) == []
    e.flush_checkpoints()  # saves are synchronous: nothing pending


def test_16bit_model_reads_back_through_the_jax_loader(tmp_path):
    """The JAX package's ``load_state_dict_from_npz`` reads the port's
    ``save_16bit_model`` file: the port's parameters rounded to bf16, bit
    for bit, under the JAX keys, 2 bytes a parameter; and
    ``params_from_jax`` of it gives back the port's bf16 state dict."""
    e = _engine(**MOE, moe_use_residual=True)
    e.train_batch(_batch(0))
    out = e.save_16bit_model(str(tmp_path), output_file="weights16")
    assert out == str(tmp_path / "weights16") and os.path.exists(out)
    tree = load_state_dict_from_npz(out)
    flat = _flatten(tree)
    want = {k: p.detach().to(torch.bfloat16) for k, p in e.module.named_parameters()}
    assert set(flat) == set(params_to_jax(want))
    n_params = sum(p.numel() for p in e.module.parameters())
    assert sum(v.nbytes for v in flat.values()) == 2 * n_params
    for path, got in zip(params_to_jax(want), want.values()):
        arr = flat[path]
        assert arr.dtype == ml_dtypes.bfloat16, path
        np.testing.assert_array_equal(arr.view(np.uint16),
                                      got.view(torch.int16).numpy().view(np.uint16), err_msg=path)
    back = params_from_jax(tree, dataclasses.replace(e.module.config, param_dtype=torch.bfloat16))
    assert set(back) == set(want)
    assert all(torch.equal(back[k], want[k]) for k in want)
    assert os.path.basename(e.save_16bit_model(str(tmp_path))) == "model_weights.npz"


@pytest.mark.parametrize("model", [{}, dict(moe_num_experts=4, moe_use_residual=True)],
                         ids=["dense", "moe-residual"])
def test_params_to_jax_inverts_params_from_jax(model):
    module = JaxGPT2(jax_config("test", **model))
    tree = jax.device_get(flax.linen.unbox(
        jax.jit(module.init)(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"]))
    flat = params_to_jax(params_from_jax(tree))
    want = _flatten(tree)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


# -- the manifest functions beside the JAX package's ----------------------------
MANIFESTS = pytest.mark.parametrize("M", [manifest, jax_manifest], ids=["port", "jax"])


def _make_ckpt(M, root, payload=b"x" * 4096):
    os.makedirs(os.path.join(root, "state"))
    with open(os.path.join(root, "state", "data.bin"), "wb") as f:
        f.write(payload)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump({"global_steps": 3}, f)
    man = M.build_manifest(root)
    M.write_manifest(root, man)
    return man


@MANIFESTS
def test_manifest_roundtrip_and_damage(tmp_path, M):
    root = str(tmp_path / "ck")
    man = _make_ckpt(M, root)
    assert M.read_manifest(root) == man
    assert set(man["files"]) == {os.path.join("state", "data.bin"), "metadata.json"}
    assert M.verify_checkpoint_dir(root) == man
    for damage, match in ((lambda p: truncate_file(p), "truncated"),
                          (lambda p: bitflip_file(p, seed=1), "sha256 mismatch"),
                          (os.remove, "missing file")):
        root = str(tmp_path / f"ck_{match[:4]}")
        _make_ckpt(M, root)
        damage(os.path.join(root, "state", "data.bin"))
        with pytest.raises(M.CheckpointCorruptError, match=match):
            M.verify_checkpoint_dir(root)
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    assert M.verify_checkpoint_dir(str(legacy)) == {}


def test_leaf_entries_hash_the_bytes_as_jax_does():
    """The port's per-leaf entry of a tensor equals JAX's of the same array
    (shape, dtype name, sha256), bf16 included; a changed value or dtype is
    another entry, and ``verify_state_leaves`` names it."""
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(ml_dtypes.bfloat16),
              "i": np.arange(6, dtype=np.int64).reshape(2, 3), "s": np.array(7, np.int64)}
    tensors = {k: (torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16)
                   if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v.copy()))
               for k, v in arrays.items()}
    port = manifest.state_leaf_entries(tensors)
    ref = jax_manifest.state_leaf_entries(arrays)
    # JAX records a 0-d leaf as shape [1] (np.ascontiguousarray lifts it to 1-d)
    assert ref["['s']"]["shape"] == [1] and port["s"]["shape"] == []
    assert {k: dict(port[k], shape=None) for k in arrays} == {
        k: dict(ref[f"['{k}']"], shape=None) for k in arrays}
    assert all(port[k]["shape"] == ref[f"['{k}']"]["shape"] for k in ("w", "b", "i"))
    assert port["w"] == manifest.leaf_entry(tensors["w"].t().contiguous().t())  # layout-free
    assert manifest.leaf_entry(tensors["w"].double())["dtype"] == "float64"
    manifest.verify_state_leaves(tensors, {"leaves": port})
    changed = dict(tensors, w=tensors["w"] + 1)
    with pytest.raises(CheckpointCorruptError, match="does not match"):
        manifest.verify_state_leaves(changed, {"leaves": port})
    with pytest.raises(CheckpointCorruptError, match="missing"):
        manifest.verify_state_leaves({"w": tensors["w"]}, {"leaves": port})


@MANIFESTS
def test_atomic_publish_and_marker(tmp_path, M):
    staging, final = str(tmp_path / ".tmp.t"), str(tmp_path / "t")
    os.makedirs(final)
    (tmp_path / "t" / "old.txt").write_text("old")
    os.makedirs(staging)
    (tmp_path / ".tmp.t" / "new.txt").write_text("new")
    M.atomic_publish(staging, final)
    assert os.listdir(final) == ["new.txt"] and not os.path.exists(staging)
    M.write_atomic_text(str(tmp_path / "latest"), "tagA")
    M.write_atomic_text(str(tmp_path / "latest"), "tagB")
    assert (tmp_path / "latest").read_text() == "tagB"
    assert sorted(os.listdir(tmp_path)) == ["latest", "t"]


@MANIFESTS
def test_list_tags_and_sweep(tmp_path, M):
    for name, steps in [("a", 1), ("b", 5), ("c", 3)]:
        (tmp_path / name / "state").mkdir(parents=True)
        (tmp_path / name / "metadata.json").write_text(json.dumps({"global_steps": steps}))
    (tmp_path / ".tmp.d" / "state").mkdir(parents=True)  # staged: invisible
    (tmp_path / "not_a_tag").mkdir()  # no state/ or manifest: ignored
    (tmp_path / "torn" / "state").mkdir(parents=True)
    (tmp_path / "torn" / "metadata.json").write_text("{not json")
    assert M.list_checkpoint_tags(str(tmp_path)) == ["b", "c", "a", "torn"]
    (tmp_path / ".tmp.live").mkdir()
    M.sweep_stale_staging(str(tmp_path), exclude=str(tmp_path / ".tmp.live"))
    assert sorted(os.listdir(tmp_path)) == [".tmp.live", "a", "b", "c", "not_a_tag", "torn"]
    # a displaced copy from a crashed overwrite is restored when the tag is gone
    (tmp_path / ".tmp.best.old.4242" / "state").mkdir(parents=True)
    (tmp_path / ".tmp.best.old.4242" / "state" / "data.bin").write_bytes(b"intact")
    (tmp_path / ".tmp.best").mkdir()
    M.sweep_stale_staging(str(tmp_path))
    assert (tmp_path / "best" / "state" / "data.bin").read_bytes() == b"intact"
    (tmp_path / ".tmp.best.old.5555").mkdir()  # the overwrite completed: junk
    M.sweep_stale_staging(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["a", "b", "best", "c", "not_a_tag", "torn"]
