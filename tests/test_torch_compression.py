"""The port's compression training against the JAX package's.

The ``compression_training`` parse equals JAX's; each pruning mask and
``qdq_weight`` (symmetric and asymmetric, bits 8 and 4, one and four
groups) is bit-equal to JAX's on seeded kernels whose values, rows,
columns and heads tie; ``scheduled_bits`` equals JAX's; on GPT-2 and BERT
trees both packages select the same leaves (a group of ``h_1`` never takes
``h_10``), and the transform's values at the steps before, at and after each
offset (where the bits halve) are JAX's bit for bit; the scheduler's flags flip as JAX's; 6
engine steps under weight quantization (JAX's
``test_engine_trains_with_compression`` setup) and under quantization with
every pruning technique against JAX's engine within 1e-5 a step (the
pruned gradients through the engine's hooks); ``redundancy_clean`` equal
to JAX's; an export of each package loaded by the other; and the
refusals, with JAX's messages.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
from deepspeed_tpu.compression import basic_layer as JBL
from deepspeed_tpu.compression import compress as jax_compress
from deepspeed_tpu.compression.compress import CompressionSpec as JaxSpec
from deepspeed_tpu.compression.config import get_compression_config as jax_get_config
from deepspeed_tpu.compression.scheduler import compression_scheduler as JaxScheduler
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_gpt2_config
from deepspeed_tpu.parallel.topology import MeshTopology
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import jax_paths, params_from_jax, params_to_jax
from deepspeed_tpu_torch.compression import (export_compressed, get_compression_config,
                                             init_compression, load_compressed, redundancy_clean,
                                             student_initialization)
from deepspeed_tpu_torch.compression import basic_layer as BL
from deepspeed_tpu_torch.compression.compress import CompressionSpec
from deepspeed_tpu_torch.compression.scheduler import compression_scheduler
from deepspeed_tpu_torch.models.common import flatten_tree, nest_tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _groups(tech, shared, **groups):
    return {tech: {"shared_parameters": dict(enabled=True, **shared),
                   "different_groups": {name: {"params": params, "modules": modules}
                                        for name, (params, modules) in groups.items()}}}


#: every technique, with offsets 1-3, two quantization groups, a glob and a
#: segment-bounded pattern. The row, head and channel masks (which sum
#: scores) take unquantized leaves: a sum of many tied quantized values
#: breaks its ties by summation order, which differs between XLA's eager
#: and jitted programs and torch's (ROADMAP Queue C); the sparse mask sums
#: nothing
FULL = {"compression_training": {
    **_groups("weight_quantization", dict(schedule_offset=1, quantize_groups=4),
              wq1=(dict(start_bits=8, target_bits=4, quantization_period=2), ["attn.c_attn"]),
              wq2=(dict(start_bits=8, target_bits=8), ["mlp.c_fc"])),
    **_groups("sparse_pruning", dict(schedule_offset=2),
              sp=(dict(dense_ratio=0.5), ["mlp.c_fc", "h_1*"])),
    **_groups("row_pruning", dict(schedule_offset=2), rp=(dict(dense_ratio=0.5), ["mlp.c_proj"])),
    **_groups("head_pruning", dict(schedule_offset=3, num_heads=4),
              hp=(dict(dense_ratio=0.5), ["attn.c_proj"])),
    **_groups("channel_pruning", dict(schedule_offset=3),
              cp=(dict(dense_ratio=0.25), ["h_1.mlp.c_proj"])),
    "layer_reduction": {"enabled": False, "teacher_layer": [1]},
    "knowledge_distillation": {"enabled": True, "temperature": 3.0},
}}


def test_config_parse_equals_jax():
    assert get_compression_config(FULL) == jax_get_config(FULL)
    assert get_compression_config({}) == jax_get_config({})


def _tied_kernel(rng, shape):
    """Values on a 1/8 grid (ties of |w|), the first two output rows and
    input channels duplicated (ties of rows, channels and heads)."""
    w = np.round(rng.standard_normal(shape) * 8.0) / 8.0
    w = w.reshape(-1, shape[-1])
    w[:, 1] = w[:, 0]
    w[1] = w[0]
    return w.reshape(shape).astype(np.float32)


KERNELS = [(16, 32), (4, 8, 32)]


@pytest.mark.parametrize("shape", KERNELS)
def test_masks_and_qdq_bit_equal_jax(shape):
    w = _tied_kernel(np.random.default_rng(len(shape)), shape)
    t = torch.from_numpy(w)
    for ratio in (0.5, 0.25, 0.3):
        pairs = [(BL.sparse_prune_mask(t, ratio), JBL.sparse_prune_mask(w, ratio)),
                 (BL.row_prune_mask(t, ratio), JBL.row_prune_mask(w, ratio)),
                 (BL.channel_prune_mask(t, ratio), JBL.channel_prune_mask(w, ratio)),
                 (BL.head_prune_mask(t, ratio, 4), JBL.head_prune_mask(w, ratio, 4))]
        for got, want in pairs:
            assert np.array_equal(got.numpy(), np.asarray(want))
    for bits in (8, 4):
        for sym in (True, False):
            for groups in (1, 4):
                got = BL.qdq_weight(t, BL.scheduled_bits(0, bits, bits, 1), groups, sym)
                want = JBL.qdq_weight(w, JBL.scheduled_bits(jnp.asarray(0), bits, bits, 1), groups, sym)
                assert np.array_equal(got.numpy(), np.asarray(want)), (bits, sym, groups)
    got = BL.quantize_activation(t, 4, symmetric=False)
    assert np.array_equal(got.numpy(), np.asarray(JBL.quantize_activation(w, 4, symmetric=False)))


def test_qdq_levels_follow_xla_pow():
    """``2 ** (bits - 1) - 1`` through XLA's float32 pow is exact at every
    width the schedule reaches, so the port's float32 pow gives its bits."""
    for bits in range(2, 17):
        want = float(2.0 ** (jnp.asarray(float(bits), jnp.float32) - 1) - 1.0)
        assert float(BL._levels(float(bits))) == want == 2.0 ** (bits - 1) - 1


def test_qdq_gradient_is_straight_through():
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(0), requires_grad=True)
    (BL.qdq_weight(w, 4.0) * torch.arange(64.0).view(8, 8)).sum().backward()
    assert torch.equal(w.grad, torch.arange(64.0).view(8, 8))


def test_scheduled_bits_equal_jax():
    for start, target, period in ((16, 4, 1), (8, 4, 3), (8, 8, 1), (4, 8, 2), (12, 2, 1)):
        for step in (-1, 0, 1, 2, 5, 9, 40):
            got = float(BL.scheduled_bits(step, start, target, period))
            assert got == float(JBL.scheduled_bits(jnp.asarray(step), start, target, period))


def _gpt2_state(n_layer=11):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", n_layer=n_layer)
    return deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu").state_dict()


def _bert_state():
    return deepspeed_tpu_torch.BertForMaskedLM(deepspeed_tpu_torch.get_bert_config("test"),
                                               device="cpu").state_dict()


#: quantization and the row and head masks on different leaves, as in FULL
BERT_GROUPS = {"compression_training": {
    **_groups("weight_quantization", dict(schedule_offset=1),
              wq=(dict(start_bits=8, target_bits=4, quantization_period=1),
                  ["attention.query", "attention.key", "attention.value", "intermediate", "pooler"])),
    **_groups("sparse_pruning", dict(schedule_offset=1), sp=(dict(dense_ratio=0.5), ["intermediate"])),
    **_groups("head_pruning", dict(schedule_offset=1, num_heads=4),
              hp=(dict(dense_ratio=0.5), ["attention.output"])),
    **_groups("row_pruning", dict(schedule_offset=1), rp=(dict(dense_ratio=0.5), ["output"])),
}}


@pytest.mark.parametrize("family", ["gpt2", "bert"])
def test_leaf_selection_and_transform_equal_jax(family):
    state, config = (_gpt2_state(), FULL) if family == "gpt2" else (_bert_state(), BERT_GROUPS)
    flat = params_to_jax(state)
    jax_spec = JaxSpec(jax_get_config(config), nest_tree(flat, "/"))
    spec = CompressionSpec(get_compression_config(config), state)
    paths = jax_paths(state)
    assert {paths[n]: [r[0] for r in rules] for n, rules in spec.rules.items()} == \
        {p: [r[0] for r in rules] for p, rules in jax_spec.rules.items()}
    if family == "gpt2":
        def techs(path):
            return [t for t, *_ in jax_spec.rules.get(path, [])]
        # "h_1.mlp.c_proj" on whole segments; the glob "h_1*" takes h_10 too
        assert "channel_pruning" in techs("h_1/mlp/c_proj/kernel")
        assert "channel_pruning" not in techs("h_10/mlp/c_proj/kernel")
        assert "sparse_pruning" in techs("h_10/attn/c_proj/kernel")
        assert "sparse_pruning" not in techs("h_2/attn/c_proj/kernel")
    else:
        assert [t for t, *_ in jax_spec.rules["bert/layer_0/attention/output/kernel"]] == \
            ["row_pruning", "head_pruning"]
        assert [t for t, *_ in jax_spec.rules["bert/layer_0/intermediate/kernel"]] == \
            ["weight_quantization", "sparse_pruning"]
    transform = jax_compress.build_compression_transform(nest_tree(flat, "/"), config)
    for step in (0, 1, 2, 3):
        got = spec.apply(state, step)
        want = flatten_tree(transform(nest_tree(flat, "/"), jnp.asarray(step)), "/")
        for name, t in got.items():
            assert np.array_equal(t.numpy(), np.asarray(want[paths[name]])), (step, name)


def test_scheduler_flags_equal_jax():
    port, ref = compression_scheduler(None, FULL), JaxScheduler(None, FULL)
    for step in range(5):
        for s in (port, ref):
            s.step(step_zero_check=(step == 0))
        assert port.verbose == ref.verbose and port.training_steps == ref.training_steps
        assert port.weight_quantization_enabled == ref.weight_quantization_enabled
        for tech in ("weight_quantization", "sparse_pruning", "head_pruning", "row_pruning",
                     "channel_pruning"):
            assert port.is_active(tech) == ref.is_active(tech)


ENGINE = {"train_batch_size": 8, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "zero_optimization": {"stage": 1}, "steps_per_print": 10**9}
MODEL = dict(n_embd=64, n_head=4, n_positions=32)
#: JAX's ``_wq_config(offset=2, target_bits=8)``; 8-bit weights and every
#: pruning technique from step 2, the score-summing masks on unquantized
#: leaves as in FULL (at 4 bits a master one ulp from JAX's can take the
#: other level and move the loss by more than the tolerance)
COMPRESSION = {
    "wq": _groups("weight_quantization", dict(schedule_offset=2),
                  wq1=(dict(start_bits=8, target_bits=8), ["*"])),
    "wq+prune": {
        **_groups("weight_quantization", dict(schedule_offset=2),
                  wq1=(dict(start_bits=8, target_bits=8), ["attn.c_attn", "mlp.c_fc", "wte"])),
        **_groups("sparse_pruning", dict(schedule_offset=2), sp=(dict(dense_ratio=0.5), ["mlp.c_fc"])),
        **_groups("row_pruning", dict(schedule_offset=2), rp=(dict(dense_ratio=0.5), ["mlp.c_proj"])),
        **_groups("head_pruning", dict(schedule_offset=2, num_heads=4),
                  hp=(dict(dense_ratio=0.5), ["attn.c_proj"])),
        **_groups("channel_pruning", dict(schedule_offset=2),
                  cp=(dict(dense_ratio=0.5), ["mlp.c_proj"]))},
}


def _batch():
    return {"input_ids": np.random.default_rng(0).integers(0, 256, (8, 32)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_engine_runs():
    out = {}
    for name, block in COMPRESSION.items():
        config = dict(ENGINE, compression_training=block)
        engine, _, _, _ = deepspeed_tpu.initialize(
            model=JaxGPT2(jax_gpt2_config("test", **MODEL)), config=config,
            topology=MeshTopology(data=1, devices=jax.devices()[:1]))
        engine.initialize_state(_batch())
        init = jax.device_get(engine.state.params)
        jax_compress.init_compression(engine)
        out[name] = (init, [float(engine.train_batch(_batch())) for _ in range(6)])
    return out


def _port_engine(init, config):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **MODEL)
    return deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"),
        model_parameters=params_from_jax(init, cfg), config=config, device="cpu")[0]


@pytest.mark.parametrize("name", COMPRESSION)
def test_engine_steps_match_jax(jax_engine_runs, name):
    init, want = jax_engine_runs[name]
    engine = _port_engine(init, dict(ENGINE, compression_training=COMPRESSION[name]))
    assert init_compression(engine) is engine
    got = [float(engine.train_batch(_batch())) for _ in range(6)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    assert rel <= 1e-5, (got, want)
    assert engine._moq_masters is None and not engine._grad_masks  # masters back between steps
    plain = _port_engine(init, dict(ENGINE))
    ref = [float(plain.train_batch(_batch())) for _ in range(3)]
    assert got[:2] == ref[:2] and got[2] != ref[2]  # the gate opens at step 2


REDUNDANCY = {"compression_training": {
    **_groups("weight_quantization", dict(schedule_offset=0),
              wq=(dict(start_bits=8, target_bits=8), ["mlp"])),
    **_groups("row_pruning", dict(schedule_offset=0), rp=(dict(dense_ratio=0.5), ["attn.c_proj"]))}}


def test_redundancy_clean_equals_jax():
    state = _gpt2_state(n_layer=1)
    flat = params_to_jax(state)
    want = flatten_tree(jax.device_get(jax_compress.redundancy_clean(nest_tree(flat, "/"), REDUNDANCY)),
                        "/")
    got = params_to_jax(redundancy_clean(state, REDUNDANCY))
    assert set(got) == set(want)
    for path, w in want.items():
        assert np.array_equal(got[path], np.asarray(w)), path
    zero_rows = (np.abs(got["h_0/attn/c_proj/kernel"]).sum(axis=(0, 1)) == 0).mean()
    assert zero_rows == 0.5


def test_exports_load_across_packages(tmp_path):
    state = _gpt2_state(n_layer=1)
    flat = params_to_jax(state)
    port_path = export_compressed(state, REDUNDANCY, str(tmp_path / "port"))
    jax_path = jax_compress.export_compressed(nest_tree(flat, "/"), REDUNDANCY, str(tmp_path / "jax"))
    for d in ("port", "jax"):
        with open(tmp_path / d / "compression_manifest.json") as f:
            assert json.load(f) == {"int8_params": ["h_0/mlp/c_fc/kernel", "h_0/mlp/c_proj/kernel"]}
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__dtypes__":
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for path in (port_path, jax_path):
        port_loaded = params_to_jax(load_compressed(path))
        jax_loaded = flatten_tree(jax_compress.load_compressed(path), "/")
        assert set(port_loaded) == set(jax_loaded) == set(flat)
        for k, v in jax_loaded.items():
            assert np.array_equal(port_loaded[k], np.asarray(v)), k
        kernel = flat["h_0/mlp/c_fc/kernel"]
        assert np.abs(port_loaded["h_0/mlp/c_fc/kernel"] - kernel).max() <= 0.02 * np.abs(kernel).max()


def _fresh_engine(config, **model_kw):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **MODEL, **model_kw)
    return deepspeed_tpu_torch.initialize(model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"),
                                          config=config, device="cpu")[0]


def test_refusals():
    engine = _fresh_engine(dict(ENGINE))
    lr = {"compression_training": {"layer_reduction": {"enabled": True, "teacher_layer": [1]}}}
    with pytest.raises(ValueError, match="Teacher model is required"):
        init_compression(engine, lr)
    with pytest.raises(TypeError, match="expects a DeepSpeedEngine"):
        init_compression(engine.module)
    engine.train_batch(_batch())
    with pytest.raises(RuntimeError, match="before the first train_batch"):
        init_compression(engine, {"compression_training": COMPRESSION["wq"]})
    teacher = deepspeed_tpu_torch.GPT2LMHeadModel(deepspeed_tpu_torch.get_gpt2_config("test", **MODEL),
                                                  device="cpu")
    kd = {"compression_training": {"knowledge_distillation": {"enabled": True}}}
    fused = init_compression(_fresh_engine(dict(ENGINE), fused_head_loss_chunk=16), kd,
                             teacher_model=teacher)
    with pytest.raises(ValueError, match="needs student logits"):
        fused.train_batch(_batch())
    offload_opt = dict(ENGINE, zero_optimization={"stage": 2, "offload_optimizer": {"device": "cpu"}})
    with pytest.raises(ValueError, match="knowledge_distillation requires the fused"):
        init_compression(_fresh_engine(offload_opt), kd, teacher_model=teacher)
    with pytest.raises(ValueError, match="does not compose with offload_optimizer"):
        init_compression(_fresh_engine(offload_opt), {"compression_training": COMPRESSION["wq"]})
    offload_param = dict(ENGINE, zero_optimization={"stage": 3, "offload_param": {"device": "cpu"}})
    with pytest.raises(ValueError, match="does not compose with offload_param"):
        init_compression(_fresh_engine(offload_param), {"compression_training": COMPRESSION["wq"]})


def test_layer_reduction_on_bert_raises_in_both():
    """Both packages look for ``layer_i`` at the top of the tree; BERT's
    layers sit under ``bert``, so its layer reduction raises ``KeyError``
    in JAX and in the port alike."""
    state = _bert_state()
    block = {"compression_training": {"layer_reduction": {
        "enabled": True, "teacher_layer": [1], "module_name_prefix": "bert.encoder.layer"}}}
    with pytest.raises(KeyError, match="layer_1"):
        student_initialization(state, state, block)
    tree = nest_tree(params_to_jax(state), "/")
    with pytest.raises(KeyError, match="layer_1"):
        jax_compress.student_initialization(tree, tree, block)
