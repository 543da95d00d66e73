"""Serving from checkpoints (``init_inference(checkpoint=...)``,
``checkpoint/zero_to_fp32.py``) against the live weights and against the
JAX package.

A port engine (GPT-2 "test", fp32, 2 AdamW steps) saves a tag and its
16-bit npz. ``init_inference(checkpoint=<tag dir>)`` (and the dict spec,
and ``base_dir`` with a relative path) must serve the live parameters'
logits within 1e-5 in fp32 (measured: 0, the same fp32 values). The npz
crosses both ways: the JAX package serving the port's npz and the port
serving a JAX ``save_16bit_model`` npz must each give the other package's
logits on the same file within 1e-5 (bf16 weights computed in fp32 by
both). The three ``ValueError`` specs raise, a flipped byte in the tag's
module file is refused, and the consolidation CLI writes an npz both
packages read.
"""

import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
from deepspeed_tpu.checkpoint.zero_to_fp32 import load_state_dict_from_npz as jax_load_npz
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
import deepspeed_tpu_torch
from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
from deepspeed_tpu_torch.checkpoint import zero_to_fp32
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models.common import flatten_tree
from deepspeed_tpu_torch.runtime.resilience.manifest import CheckpointCorruptError

ATOL = 1e-5
MODEL = dict(n_layer=2)
IDS = (np.arange(32, dtype=np.int32).reshape(2, 16) * 7) % 256


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model():
    return GPT2LMHeadModel(get_gpt2_config("test", **MODEL), device="cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_model(), config={"train_batch_size": 8,
                                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}},
        device="cpu")
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (8, 32)).astype(np.int64)}
    for _ in range(2):
        engine.train_batch(batch)
    engine.save_checkpoint(str(d / "save"))
    engine.save_16bit_model(str(d / "deploy"))
    live = {k: v.detach().clone() for k, v in engine.module.state_dict().items()}
    return d, live


def _port_logits(**source):
    return init_inference(_model(), device="cpu", **source).forward(IDS).numpy()


def _jax_logits(**source):
    set_topology(None)
    serve = deepspeed_tpu.init_inference(JaxGPT2(jax_config("test", **MODEL)), dtype=jnp.float32,
                                         replace_with_kernel_inject=False, **source)
    out = np.asarray(serve(IDS))
    set_topology(None)
    return out


@pytest.mark.parametrize("spec", ["dir", "dict", "base_dir"])
def test_serve_from_engine_checkpoint(trained, spec):
    d, live = trained
    want = _port_logits(params=live)
    source = {"dir": dict(checkpoint=str(d / "save")),
              "dict": dict(checkpoint={"checkpoint_dir": str(d / "save"), "tag": "global_step2"}),
              "base_dir": dict(checkpoint="save", base_dir=str(d))}[spec]
    got = _port_logits(**source)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_port_npz_served_by_both_packages(trained):
    d, live = trained
    port = _port_logits(checkpoint=str(d / "deploy"))
    # bf16 deployment weights: within bf16 rounding of the live logits
    np.testing.assert_allclose(port, _port_logits(params=live), atol=0.05, rtol=0.05)
    jax_side = _jax_logits(checkpoint=str(d / "deploy" / zero_to_fp32.WEIGHTS_NAME))
    np.testing.assert_allclose(port, jax_side, rtol=0, atol=ATOL)


def test_jax_npz_served_by_the_port(tmp_path):
    set_topology(None)
    engine, *_ = deepspeed_tpu.initialize(
        model=JaxGPT2(jax_config("test", **MODEL)),
        topology=MeshTopology(data=1, devices=jax.devices()[:1]),
        config={"train_batch_size": 2, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    engine.initialize_state({"input_ids": np.zeros((2, 16), np.int32)})
    engine.save_16bit_model(str(tmp_path))
    want = _jax_logits(checkpoint=str(tmp_path))
    got = _port_logits(checkpoint=str(tmp_path))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    state = params_from_jax(zero_to_fp32.load_state_dict_from_npz(str(tmp_path)))
    assert all(t.dtype == torch.bfloat16 for t in state.values())


def test_consolidation_cli_and_npz_round_trip(trained, tmp_path, capsys):
    d, live = trained
    zero_to_fp32.main([str(d / "save"), str(tmp_path / "fp32")])
    path = capsys.readouterr().out.strip()
    assert path == os.path.join(str(tmp_path / "fp32"), zero_to_fp32.WEIGHTS_NAME)
    sd = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(d / "save"))
    assert set(sd) == set(live) and all(torch.equal(sd[k], live[k]) for k in live)
    back = params_from_jax(zero_to_fp32.load_state_dict_from_npz(path))
    assert all(torch.equal(back[k], live[k]) for k in live)
    jax_tree = flatten_tree(jax_load_npz(path), "/")
    assert params_from_jax(jax_tree).keys() == live.keys()
    out = zero_to_fp32.convert_zero_checkpoint_to_fp32_state_dict(
        str(d / "save"), str(tmp_path / "bf16"), tag="global_step2", save_dtype="bfloat16")
    jax_bf16 = flatten_tree(jax_load_npz(out), "/")
    assert all(v.dtype.name == "bfloat16" for v in jax_bf16.values())
    with pytest.raises(FileNotFoundError):
        zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))


@pytest.mark.parametrize("spec,match", [(123, "unsupported"), ({"tag": "x"}, "unsupported"),
                                        ("missing.npz", "does not exist"), ("nope", "neither")])
def test_bad_checkpoint_specs_raise(tmp_path, spec, match):
    with pytest.raises(ValueError, match=match):
        init_inference(_model(), device="cpu", checkpoint=spec, base_dir=str(tmp_path))


def test_a_corrupt_module_file_is_refused(trained, tmp_path):
    d, _ = trained
    shutil.copytree(str(d / "save"), str(tmp_path / "save"))
    path = tmp_path / "save" / "global_step2" / "state" / "module.pt"
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(CheckpointCorruptError, match="sha256"):
        _port_logits(checkpoint=str(tmp_path / "save"))
