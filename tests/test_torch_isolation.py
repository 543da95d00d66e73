"""The PyTorch port stands alone: no module of ``deepspeed_tpu_torch/`` and
not ``chip_smoke.py`` imports JAX, flax or the JAX package, and the entry
points refuse to run without CUDA unless the CPU is asked for by name."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import (GPT2LMHeadModel, get_gpt2_config, init_inference, initialize,
                                 resolve_device)
from deepspeed_tpu_torch.ops.cuda import LAUNCHES, reset_launches


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deepspeed_tpu")


def _port_sources():
    files = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ("runtime/engine.py", "runtime/entry.py", "runtime/config.py",
                   "runtime/lr_schedules.py", "runtime/utils.py", "ops/adam/fused_adam.py",
                   "ops/cuda/flash_attention.py", "models/common.py", "ops/cuda/moe_dispatch.py",
                   "moe/routing.py", "moe/sharded_moe.py", "moe/layer.py", "moe/experts.py",
                   "moe/mappings.py", "moe/utils.py", "ops/cuda/sparse_attention.py",
                   "ops/sparse_attention/__init__.py",
                   "ops/sparse_attention/sparse_self_attention.py",
                   "ops/sparse_attention/sparsity_config.py", "runtime/dataloader.py",
                   "runtime/resilience/manifest.py", "runtime/checkpoint_engine/checkpoint_engine.py",
                   "runtime/checkpoint_engine/torch_engine.py", "utils/tensor_fragment.py",
                   "runtime/resilience/faults.py", "runtime/resilience/retry.py",
                   "runtime/resilience/signals.py", "runtime/fp16/loss_scaler.py",
                   "runtime/elastic/agent.py", "elasticity/elasticity.py",
                   "elasticity/elastic_agent.py", "inference/fleet/protocol.py",
                   "inference/fleet/migrate.py", "inference/fleet/replica.py",
                   "inference/fleet/router.py", "inference/fleet/autoscaler.py",
                   "inference/fleet/worker.py"):
        assert f"deepspeed_tpu_torch/{module}" in names, module
    return files


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    bad = []
    for path in _port_sources():
        for name in _imported_modules(path):
            top = name.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_package_path_is_the_port():
    assert pathlib.Path(deepspeed_tpu_torch.__file__).parent == ROOT / "deepspeed_tpu_torch"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_without_cuda(no_cuda):
    cfg = get_gpt2_config("test")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT2LMHeadModel(cfg)
    model = GPT2LMHeadModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_inference(model)
    assert resolve_device("cpu") == torch.device("cpu")
    engine = init_inference(model, device="cpu")
    assert engine.device.type == "cpu"


def test_cpu_runs_the_plain_versions_and_counts_no_launch():
    reset_launches()
    model = GPT2LMHeadModel(get_gpt2_config("test", attention_backend="flash",
                                            serve_weight_dtype="int8"), device="cpu")
    engine = init_inference(model, device="cpu")
    engine.generate(np.zeros((1, 5), np.int32), max_new_tokens=2)
    model = GPT2LMHeadModel(get_gpt2_config("test", attention_backend="flash", remat=True,
                                            fused_head_loss_chunk=16), device="cpu")
    trainer, _, _, _ = initialize(model=model, config={"train_batch_size": 2}, device="cpu")
    trainer.train_batch(np.zeros((2, 12), np.int32))
    model = GPT2LMHeadModel(get_gpt2_config("test", attention_backend="flash", remat=True,
                                            moe_num_experts=4), device="cpu")
    trainer, _, _, _ = initialize(model=model, config={"train_batch_size": 2}, device="cpu")
    trainer.train_batch(np.zeros((2, 12), np.int32))
    from deepspeed_tpu_torch.ops.sparse_attention import (FixedSparsityConfig,
                                                          SparseSelfAttention)
    attn = SparseSelfAttention(FixedSparsityConfig(num_heads=2, block=16,
                                                   attention="unidirectional"))
    q = torch.randn(1, 64, 2, 64, requires_grad=True)
    attn(q, q, q).sum().backward()
    assert torch.isfinite(q.grad).all()
    assert all(count == 0 for count in LAUNCHES.values()), LAUNCHES


def test_importing_builds_nothing():
    """Kernels build on first CUDA use, never at import (no nvcc on a CPU host)."""
    from deepspeed_tpu_torch.ops.cuda import build
    assert build.KERNELS == ("flash_fwd", "flash_bwd", "flash_decode", "quant_matmul",
                             "moe_permute", "sparse_fwd", "sparse_bwd")
    assert set(build.KERNELS) == set(build.SIGNATURES) == set(LAUNCHES)
    for name in build.KERNELS:
        assert (build.CSRC_DIR / f"{name}.cu").is_file()
    assert not build._loaded
