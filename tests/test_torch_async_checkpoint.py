"""Async (``nebula``) checkpoint saves of the port, mirroring JAX's
``tests/unit/checkpoint/test_async_engine.py``: ``latest`` is deferred until
the flush and the restored state is the one at the save; the next save
commits the previous one; a load flushes first; synchronous mode is
unchanged. Beyond JAX's file: the async tag's leaf digests equal a
synchronous save's of the same state, steps taken while a save is pending
leave the saved bytes as they were, a writer's error is raised at the flush
and never published, a torn save (``ckpt_pre_rename=sigkill`` in the
commit) stays invisible and ``resume()`` recovers the older tag, and the
exit hook publishes a save still pending at ``SystemExit(143)``. GPT-2
"test" (2 layers, fp32) on the CPU; comparisons are exact; two child
processes.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime.resilience import manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, the suite's parallel
    workers share the host's cores, and the children take one too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(nebula: bool) -> dict:
    ds = {"train_batch_size": 8, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "zero_optimization": {"stage": 0}}
    if nebula:
        ds["nebula"] = {"enabled": True, "persistent_time_interval": 100}
    return ds


def _engine(nebula: bool):
    model = deepspeed_tpu_torch.GPT2LMHeadModel(
        deepspeed_tpu_torch.get_gpt2_config("test"), device="cpu",
        generator=torch.Generator().manual_seed(0))
    return deepspeed_tpu_torch.initialize(model=model, config=_config(nebula), device="cpu")[0]


def _batch(step=0):
    return np.random.default_rng(step).integers(0, 256, (8, 32)).astype(np.int32)


def _state(engine):
    return {k: v.detach().clone() for k, v in engine.checkpoint_state().items()}


def _assert_state(engine, want):
    got = engine.checkpoint_state()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_async_save_defers_latest_until_flush(tmp_path):
    engine = _engine(nebula=True)
    engine.train_batch(_batch(0))
    snap = _state(engine)
    engine.save_checkpoint(str(tmp_path), tag="tagA")
    # the marker and the tag wait for the flush; training goes on meanwhile
    assert not os.path.exists(tmp_path / "latest")
    assert manifest.list_checkpoint_tags(str(tmp_path)) == []
    engine.train_batch(_batch(1))
    engine.flush_checkpoints()
    assert (tmp_path / "latest").read_text() == "tagA"
    # the restored state is the one at the save, not the one after it
    engine.load_checkpoint(str(tmp_path))
    _assert_state(engine, snap)
    assert engine.global_steps == 1


def test_next_save_commits_previous(tmp_path):
    engine = _engine(nebula=True)
    engine.train_batch(_batch(0))
    engine.save_checkpoint(str(tmp_path), tag="tagA")
    assert not os.path.exists(tmp_path / "latest")
    engine.train_batch(_batch(1))
    engine.save_checkpoint(str(tmp_path), tag="tagB")
    assert (tmp_path / "latest").read_text() == "tagA"  # entering save B committed A
    engine.flush_checkpoints()
    assert (tmp_path / "latest").read_text() == "tagB"
    assert manifest.list_checkpoint_tags(str(tmp_path)) == ["tagB", "tagA"]


def test_load_and_resume_flush_a_pending_save(tmp_path):
    engine = _engine(nebula=True)
    engine.train_batch(_batch(0))
    engine.save_checkpoint(str(tmp_path), tag="only")
    engine.load_checkpoint(str(tmp_path))  # no flush: the load commits first
    assert (tmp_path / "latest").read_text() == "only"
    engine.train_batch(_batch(1))
    engine.save_checkpoint(str(tmp_path / "r"), tag="pending")
    assert engine.resume(str(tmp_path / "r")) == ("pending", {})  # not swept as stale staging


def test_sync_mode_unchanged(tmp_path):
    engine = _engine(nebula=False)
    engine.train_batch(_batch(0))
    engine.save_checkpoint(str(tmp_path), tag="s")
    assert (tmp_path / "latest").read_text() == "s"
    assert engine._pending_ckpt is None
    engine.flush_checkpoints()  # a no-op


def test_async_digests_equal_sync_and_pending_steps_change_nothing(tmp_path):
    """Two engines from one init take the same step; one saves
    synchronously, the other asynchronously and trains two more steps
    before its flush: the tags' leaf digests are equal, equal to the state
    at the save, and the async tag loads under full verification."""
    sync, nebula = _engine(nebula=False), _engine(nebula=True)
    for engine in (sync, nebula):
        engine.train_batch(_batch(0))
    snap = _state(nebula)
    sync.save_checkpoint(str(tmp_path / "sync"), tag="t")
    nebula.save_checkpoint(str(tmp_path / "async"), tag="t")
    nebula.train_batch(_batch(1))
    nebula.train_batch(_batch(2))
    nebula.flush_checkpoints()
    leaves = {k: manifest.read_manifest(str(tmp_path / k / "t"))["leaves"] for k in ("sync", "async")}
    assert leaves["async"] == leaves["sync"] == manifest.state_leaf_entries(snap)
    manifest.verify_checkpoint_dir(str(tmp_path / "async" / "t"))
    fresh = _engine(nebula=False)
    fresh.load_checkpoint(str(tmp_path / "async"))  # verify_checkpoint "full" by default
    _assert_state(fresh, snap)


def test_a_writer_error_is_raised_at_the_flush(tmp_path, monkeypatch):
    engine = _engine(nebula=True)
    engine.train_batch(_batch(0))

    def disk_full(*args, **kwargs):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(torch, "save", disk_full)
    engine.save_checkpoint(str(tmp_path), tag="bad")
    with pytest.raises(OSError, match="No space left"):
        engine.flush_checkpoints()
    monkeypatch.undo()
    assert manifest.list_checkpoint_tags(str(tmp_path)) == []
    assert not os.path.exists(tmp_path / "latest")
    engine.flush_checkpoints()  # the failed save is no longer pending
    engine.save_checkpoint(str(tmp_path), tag="good")  # sweeps the failed staging dir
    engine.flush_checkpoints()
    assert sorted(os.listdir(tmp_path)) == ["good", "latest"]


# A child on the CPU: two async saves; the second one's commit dies by
# SIGKILL (TORN) or the process leaves with the save still pending (EXIT).
CHILD = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, __REPO__)
    import numpy as np, torch
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as ds
    model = ds.GPT2LMHeadModel(ds.get_gpt2_config("test"), device="cpu",
                               generator=torch.Generator().manual_seed(0))
    engine = ds.initialize(model=model, device="cpu", config=__CONFIG__)[0]
    ckpt, mode = sys.argv[1], sys.argv[2]
    for step in range(2):
        engine.train_batch(np.random.default_rng(step).integers(0, 256, (8, 32)).astype(np.int32))
        if step == 1 and mode == "torn":
            os.environ["DS_FAULT_SPEC"] = "ckpt_pre_rename=sigkill"
        engine.save_checkpoint(ckpt)
        if step == 1 and mode == "exit":
            raise SystemExit(143)  # the save of step 2 is still pending
        engine.flush_checkpoints()
    raise AssertionError("unreachable")
""").replace("__REPO__", repr(REPO)).replace("__CONFIG__", repr(_config(nebula=True)))


def _child(tmp_path, mode):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    env = {k: v for k, v in os.environ.items() if k != "DS_FAULT_SPEC"}
    env["OMP_NUM_THREADS"] = "1"
    ckpt = tmp_path / "ckpt"
    proc = subprocess.run([sys.executable, str(script), str(ckpt), mode], env=env,
                          capture_output=True, text=True, timeout=300)
    return proc, ckpt


def _reference():
    engine = _engine(nebula=False)
    return [float(engine.train_batch(_batch(s))) for s in range(2)], engine


def test_torn_save_is_invisible_and_resume_recovers_the_older_tag(tmp_path):
    proc, ckpt = _child(tmp_path, "torn")
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert manifest.list_checkpoint_tags(str(ckpt)) == ["global_step1"]
    assert (ckpt / "latest").read_text() == "global_step1"
    assert os.path.isdir(ckpt / ".tmp.global_step2")  # staged in full, never renamed
    want, _ = _reference()
    engine = _engine(nebula=True)
    assert engine.resume(str(ckpt)) == ("global_step1", {})
    assert not os.path.exists(ckpt / ".tmp.global_step2")  # swept
    assert float(engine.train_batch(_batch(1))) == want[1]


def test_exit_hook_publishes_a_save_pending_at_system_exit(tmp_path):
    proc, ckpt = _child(tmp_path, "exit")
    assert proc.returncode == 143, proc.stderr[-2000:]
    assert manifest.list_checkpoint_tags(str(ckpt)) == ["global_step2", "global_step1"]
    assert (ckpt / "latest").read_text() == "global_step2"
    _, reference = _reference()
    engine = _engine(nebula=False)
    assert engine.resume(str(ckpt)) == ("global_step2", {})  # verified in full
    _assert_state(engine, _state(reference))
    with open(ckpt / "global_step2" / "metadata.json") as f:
        assert json.load(f)["global_steps"] == 2
