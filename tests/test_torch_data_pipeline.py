"""The data-efficiency pipeline of the port against the JAX package's.

- Curriculum: the four schedule types step for step and ``get_state``
  equal; JAX's ``test_engine_seqlen_curriculum_ramp`` configuration (GPT-2
  "test", 1 layer, seq 32, batch 8, difficulty 8 to 32 in steps of 8) through
  both engines from the same weights, losses within 1e-5 at every step and
  the scheduler's state equal after every step; the state saved in a tag and
  restored, the resumed steps bit-equal to the uninterrupted run.
- Indexed datasets: files written by either package read back by the other,
  and written byte-equal by both, in the native and the Megatron layouts,
  merges included.
- The analyzer: every output file of a three-worker map/reduce byte-equal.
- The sampler: each rank's index sequence equal to JAX's (with and without a
  curriculum), and a resume from ``state_dict``.
- ``data_efficiency``: taken and stored as JAX stores it.
"""

import os

import numpy as np
import pytest

import jax
import torch

import deepspeed_tpu
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.data_pipeline import curriculum_scheduler as jax_cs
from deepspeed_tpu.runtime.data_pipeline.data_sampling import data_analyzer as jax_da
from deepspeed_tpu.runtime.data_pipeline.data_sampling import data_sampler as jax_ds
from deepspeed_tpu.runtime.data_pipeline.data_sampling import indexed_dataset as jax_ix
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.data_pipeline import curriculum_scheduler as port_cs
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import data_analyzer as port_da
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import data_sampler as port_ds
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import indexed_dataset as port_ix


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CURVE_RTOL = 1e-5

SCHEDULES = {
    "fixed_linear": {"min_difficulty": 8, "max_difficulty": 1024, "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 37, "difficulty_step": 8}},
    "fixed_root": {"min_difficulty": 2, "max_difficulty": 100, "schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 50, "difficulty_step": 3,
                                       "root_degree": 3}},
    "fixed_discrete": {"min_difficulty": 1, "max_difficulty": 9, "schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [1, 4, 9], "max_step": [5, 12]}},
    "custom": {"min_difficulty": 4, "max_difficulty": 64, "schedule_type": "custom"},
}


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedules_step_for_step(name):
    port, ref = port_cs.CurriculumScheduler(SCHEDULES[name]), jax_cs.CurriculumScheduler(SCHEDULES[name])
    if name == "custom":
        for s in (port, ref):
            s.set_custom_get_difficulty(lambda step: min(4 + 3 * step, 64))
    for step in range(0, 80):
        assert port.update_difficulty(step) == ref.update_difficulty(step), step
        assert port.get_state() == ref.get_state()
    twin = port_cs.CurriculumScheduler(SCHEDULES[name])
    twin.set_state(dict(ref.get_state()))
    assert twin.get_current_difficulty() == ref.get_current_difficulty()


CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8,
              "max_difficulty": 32, "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 4, "difficulty_step": 8}}
CONFIG = {"train_batch_size": 8, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "zero_optimization": {"stage": 0}, "steps_per_print": 10**9,
          "curriculum_learning": CURRICULUM}
STEPS = 6
SAVE_AT = 3


def _batch():
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(0, 256, (8, 32)).astype(np.int32)}


def _port_engine(tree):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", n_layer=1, dropout=0.0)
    model = deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu")
    return deepspeed_tpu_torch.initialize(model=model, model_parameters=params_from_jax(tree, cfg),
                                          config=dict(CONFIG), device="cpu")[0]


@pytest.fixture(scope="module")
def jax_curve():
    """JAX's engine on JAX's ramp configuration: its initial weights, the
    loss and the scheduler's state after every step."""
    engine = deepspeed_tpu.initialize(
        model=JaxGPT2(jax_config("test", n_layer=1, dropout=0.0)), config=dict(CONFIG),
        topology=MeshTopology(data=1, devices=jax.devices()[:1]))[0]
    batch = _batch()
    engine.initialize_state({"input_ids": batch["input_ids"][:, :8]})
    out = {"init": jax.device_get(engine.state.params), "losses": [], "states": []}
    for _ in range(STEPS):
        out["losses"].append(float(engine.train_batch(batch)))
        out["states"].append(dict(engine.curriculum_scheduler.get_state()))
    return out


def test_engine_seqlen_curriculum_matches_jax(jax_curve, tmp_path):
    engine = _port_engine(jax_curve["init"])
    batch = _batch()
    losses, lengths = [], []
    seen = []
    engine.module.register_forward_pre_hook(lambda m, args: seen.append(args[0].shape[1]))
    for i in range(STEPS):
        losses.append(float(engine.train_batch(batch)))
        assert engine.curriculum_scheduler.get_state() == jax_curve["states"][i]
        lengths.append(seen[-1])
        if i + 1 == SAVE_AT:
            engine.save_checkpoint(str(tmp_path))
    assert lengths == [8, 16, 24, 32, 32, 32]  # floor(8 + 6 step) down to a multiple of 8
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, jax_curve["losses"]))
    assert rel <= CURVE_RTOL, (losses, jax_curve["losses"])
    assert engine.curriculum_scheduler.get_current_difficulty() == 32

    # the checkpointed state: a fresh engine resumes mid-ramp, bit-equal
    fresh = _port_engine(jax_curve["init"])
    fresh.load_checkpoint(str(tmp_path))
    assert fresh.curriculum_scheduler.get_state() == jax_curve["states"][SAVE_AT - 1]
    resumed = [float(fresh.train_batch(batch)) for _ in range(STEPS - SAVE_AT)]
    assert resumed == losses[SAVE_AT:]


def _write(mod, prefix, seqs, fmt, docs_every=None):
    b = mod.MMapIndexedDatasetBuilder(prefix, dtype=np.uint16 if fmt == "megatron" else np.int32,
                                      fmt=fmt)
    for i, s in enumerate(seqs):
        b.add_item(s)
        if docs_every and (i + 1) % docs_every == 0:
            b.end_document()
    b.finalize()


def _seqs(seed, n=23):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 5000, rng.integers(1, 40)) for _ in range(n)]


def _bytes(prefix):
    return [open(prefix + ext, "rb").read() for ext in (".bin", ".idx")]


@pytest.mark.parametrize("fmt", ["native", "megatron"])
def test_indexed_datasets_cross_read_and_write_byte_equal(tmp_path, fmt):
    seqs, more = _seqs(0), _seqs(1, 9)
    docs = 4 if fmt == "megatron" else None
    for tag, mod in (("port", port_ix), ("jax", jax_ix)):
        _write(mod, str(tmp_path / f"{tag}_a"), seqs, fmt, docs)
        _write(mod, str(tmp_path / f"{tag}_b"), more, fmt, docs)
        merged = mod.MMapIndexedDatasetBuilder(str(tmp_path / f"{tag}_m"),
                                               dtype=np.uint16 if fmt == "megatron" else np.int32,
                                               fmt=fmt)
        merged.merge_file_(str(tmp_path / f"{tag}_a"))
        merged.merge_file_(str(tmp_path / f"{tag}_b"))
        merged.finalize()
    for name in ("a", "b", "m"):
        assert _bytes(str(tmp_path / f"port_{name}")) == _bytes(str(tmp_path / f"jax_{name}"))
        for writer, reader in (("port", jax_ix), ("jax", port_ix)):
            ds = reader.MMapIndexedDataset(str(tmp_path / f"{writer}_{name}"))
            other = (port_ix if reader is jax_ix else jax_ix).MMapIndexedDataset(
                str(tmp_path / f"{writer}_{name}"))
            assert ds.fmt == other.fmt == fmt and len(ds) == len(other)
            np.testing.assert_array_equal(ds.sizes, other.sizes)
            np.testing.assert_array_equal(ds.doc_idx, other.doc_idx)
            for i in range(len(ds)):
                assert ds[i].tobytes() == other[i].tobytes()
                assert ds.get(i, 1, 2).tobytes() == other.get(i, 1, 2).tobytes()
    want = seqs + more
    ds = port_ix.MMapIndexedDataset(str(tmp_path / "jax_m"))
    assert [list(ds[i]) for i in range(len(ds))] == [list(s) for s in want]


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def test_analyzer_output_files_equal(tmp_path):
    rng = np.random.default_rng(3)
    corpus = [rng.integers(0, 100, rng.integers(2, 20)).astype(np.int32) for _ in range(41)]
    names = ["seqlen", "vocab_total"]
    fns = {"seqlen": len, "vocab_total": lambda s: int(np.sum(s))}
    types = {"seqlen": "single_value_per_sample", "vocab_total": "accumulate_value"}
    for tag, mod in (("port", port_da), ("jax", jax_da)):
        mod.DataAnalyzer(corpus, names, fns, str(tmp_path / tag), metric_types=types,
                         num_workers=3).run_map_reduce()
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(ref) and len(port) >= 10
    for k in ref:
        assert port[k] == ref[k], k


def _sampler(mod, metric, rank, world, curriculum):
    cfg = {"seed": 7}
    if curriculum:
        cfg["data_sampling"] = {"curriculum_learning": {"enabled": True, "curriculum_metrics": {
            "seqlen": {"min_difficulty": 2, "max_difficulty": 10, "schedule_type": "fixed_linear",
                       "schedule_config": {"total_curriculum_step": 6, "difficulty_step": 1},
                       "difficulty_type": "value"}}}}
    return mod.DeepSpeedDataSampler(cfg, one_epoch_total_samples=len(metric), micro_batch_size=4,
                                    data_parallel_rank=rank, data_parallel_size=world,
                                    gradient_accumulation_steps=2,
                                    metric_values={"seqlen": metric} if curriculum else None)


@pytest.mark.parametrize("curriculum", [False, True])
def test_sampler_index_sequence_per_rank_equals_jax(curriculum):
    metric = np.array([2] * 30 + [6] * 20 + [10] * 14)
    for rank in range(2):
        port = iter(_sampler(port_ds, metric, rank, 2, curriculum))
        ref = iter(_sampler(jax_ds, metric, rank, 2, curriculum))
        got = [next(port) for _ in range(12)]
        assert got == [next(ref) for _ in range(12)]
    # a resume from state_dict continues the sequence
    s = _sampler(port_ds, metric, 0, 2, curriculum)
    it = iter(s)
    for _ in range(6):
        next(it)
    saved, rest = s.state_dict(), [next(it) for _ in range(4)]
    twin = _sampler(port_ds, metric, 0, 2, curriculum)
    twin.load_state_dict(saved)
    assert [b for _, b in zip(range(4), iter(twin))] == rest


def test_data_efficiency_is_taken_and_stored_as_jax():
    block = {"enabled": True, "seed": 3, "data_sampling": {"num_epochs": 2}}
    raw = {"train_batch_size": 8, "data_efficiency": block}
    assert DeepSpeedConfig(dict(raw)).data_efficiency_config == \
        JaxConfig(dict(raw), world_size=1).data_efficiency_config == block
