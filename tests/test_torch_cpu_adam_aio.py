"""The port's host optimizers and async file I/O against the JAX package's.

``DeepSpeedCPUAdam`` (``step`` and ``begin_step``/``step_single``, the bf16
copy), ``DeepSpeedCPUAdagrad`` and ``NVMeAdam`` are built by the port from
its own copies of the C++ sources (``deepspeed_tpu_torch/csrc/host/``) with
the JAX package's flags, so on the same seeded numpy arrays they must give
JAX's bits exactly. The host Adam is held to the port's ``FusedAdam`` plain
version within JAX's ``test_cpu_adam_matches_optax`` tolerance (rtol 2e-5,
atol 2e-6: a fused multiply-add and another order of the bias corrections).
A file written by either package's ``AsyncIOHandle`` is read back by the
other's, buffered and O_DIRECT.
"""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdagrad as JaxCPUAdagrad
from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam
from deepspeed_tpu.ops.aio import AsyncIOHandle as JaxAIO
from deepspeed_tpu.runtime.swap_tensor import NVMeAdam as JaxNVMeAdam
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdagrad, DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.ops.op_builder import HOST_BUILD_DIR, HOST_CSRC_DIR, AsyncIOBuilder, CPUAdamBuilder
from deepspeed_tpu_torch.runtime.swap_tensor import NVMeAdam


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: odd sizes: the AVX body and the scalar tail
SHAPES = [(2053,), (16, 33), (7,)]
#: (adamw_mode, weight_decay, betas, bias_correction)
ADAM_CASES = {"adamw-decay": (True, 0.01, (0.9, 0.95), True),
              "adam-l2": (False, 0.1, (0.9, 0.999), True),
              "no-decay": (True, 0.0, (0.8, 0.99), True),
              "no-bias-correction": (True, 0.01, (0.9, 0.999), False)}


def _arrays(seed, n_steps=4):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES] for _ in range(n_steps)]
    return params, grads


@pytest.mark.parametrize("case", ADAM_CASES)
@pytest.mark.parametrize("entry", ["step", "step_single"])
def test_cpu_adam_gives_jax_bits(case, entry):
    adamw, wd, betas, bc = ADAM_CASES[case]
    kw = dict(lr=1e-2, betas=betas, eps=1e-8, weight_decay=wd, bias_correction=bc, adamw_mode=adamw)
    params, grads = _arrays(1)
    ours, theirs = [p.copy() for p in params], [p.copy() for p in params]
    # the port's operands as CPU tensors, JAX's as numpy arrays
    ours_t = [torch.from_numpy(p) for p in ours]
    port, jax_opt = DeepSpeedCPUAdam(**kw), JaxCPUAdam(**kw)
    for gs in grads:
        if entry == "step":
            port.step(ours_t, [torch.from_numpy(g.copy()) for g in gs])
            jax_opt.step(theirs, [g.copy() for g in gs])
        else:
            port.begin_step(lr=5e-3)
            jax_opt.begin_step(lr=5e-3)
            for i in reversed(range(len(gs))):  # the index keys the moments, not the order
                port.step_single(i, ours_t[i], gs[i])
                jax_opt.step_single(i, theirs[i], gs[i])
    for a, b in zip(ours, theirs):
        assert a.tobytes() == b.tobytes()
    sd_port, sd_jax = port.state_dict(), jax_opt.state_dict()
    assert sd_port["step"] == sd_jax["step"] == len(grads)
    for k in sd_jax["state"]:
        for m in ("m", "v"):
            assert sd_port["state"][k][m].tobytes() == sd_jax["state"][k][m].tobytes()


@pytest.mark.parametrize("case", ["adamw-decay", "adam-l2"])
def test_cpu_adam_split_across_threads_gives_jax_bits(case):
    """A leaf of 4 Mi + 13 elements: the port splits it across threads at
    multiples of 8 elements, JAX's runs it on one core; the bits are the
    same, the scalar tail's included."""
    adamw, wd, betas, bc = ADAM_CASES[case]
    kw = dict(lr=1e-2, betas=betas, eps=1e-8, weight_decay=wd, bias_correction=bc, adamw_mode=adamw)
    rng = np.random.default_rng(3)
    n = (4 << 20) + 13
    ours = rng.normal(size=n).astype(np.float32)
    theirs = ours.copy()
    port, jax_opt = DeepSpeedCPUAdam(**kw), JaxCPUAdam(**kw)
    for _ in range(2):
        g = rng.normal(size=n).astype(np.float32)
        port.step([ours], [g])
        jax_opt.step([theirs], [g])
    assert ours.tobytes() == theirs.tobytes()
    for m in ("m", "v"):
        assert port.state[0][m].tobytes() == jax_opt.state_dict()["state"]["0"][m].tobytes()


def test_cpu_adam_bf16_copy_gives_jax_bits():
    params, grads = _arrays(2, n_steps=2)
    ours, theirs = [p.copy() for p in params], [p.copy() for p in params]
    out_port = [torch.zeros(p.shape, dtype=torch.bfloat16) for p in params]
    out_jax = [np.zeros(p.shape, np.uint16) for p in params]
    port, jax_opt = DeepSpeedCPUAdam(lr=0.1), JaxCPUAdam(lr=0.1)
    for gs in grads:
        port.step(ours, gs, bf16_out=out_port)
        jax_opt.step(theirs, gs, bf16_out=out_jax)
    for a, b, p in zip(out_port, out_jax, ours):
        assert a.view(torch.int16).numpy().view(np.uint16).tobytes() == b.tobytes()
        # the copy is the master rounded to bf16 (round to nearest even)
        assert torch.equal(a, torch.from_numpy(p).to(torch.bfloat16))


def test_cpu_adam_state_dict_round_trip():
    params, grads = _arrays(3)
    a, b = [p.copy() for p in params], [p.copy() for p in params]
    one = DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.01)
    for gs in grads[:2]:
        one.step(a, gs)
    two = DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.01)
    two.load_state_dict({k: v for k, v in one.state_dict().items()})
    b = [p.copy() for p in a]
    for gs in grads[2:]:
        one.step(a, gs)
        two.step(b, gs)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    one.reset_state()
    assert one.step_count == 0 and one.state == {}


def test_cpu_adagrad_gives_jax_bits():
    params, grads = _arrays(4)
    ours, theirs = [p.copy() for p in params], [p.copy() for p in params]
    port, jax_opt = DeepSpeedCPUAdagrad(lr=0.1, weight_decay=0.01), JaxCPUAdagrad(lr=0.1, weight_decay=0.01)
    for gs in grads:
        port.step([torch.from_numpy(p) for p in ours], gs)
        jax_opt.step(theirs, gs)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(ours, theirs))


def test_nvme_adam_gives_jax_bits_and_the_cpu_adams(tmp_path):
    params, grads = _arrays(5)
    ours, theirs, cpu = ([p.copy() for p in params] for _ in range(3))
    port = NVMeAdam(swap_dir=str(tmp_path / "port"), lr=1e-2, weight_decay=0.01)
    jax_opt = JaxNVMeAdam(swap_dir=str(tmp_path / "jax"), lr=1e-2, weight_decay=0.01)
    host = DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.01)
    for gs in grads:
        port.step(ours, [g.copy() for g in gs])
        jax_opt.step(theirs, [g.copy() for g in gs])
        host.step(cpu, [g.copy() for g in gs])
    for a, b, c in zip(ours, theirs, cpu):
        assert a.tobytes() == b.tobytes() == c.tobytes()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted([f"exp_avg_{i}.bin" for i in range(3)] + [f"exp_avg_sq_{i}.bin" for i in range(3)])
    sd = port.state_dict()
    for k, st in host.state_dict()["state"].items():
        assert sd["state"][k]["m"].tobytes() == st["m"].tobytes()
        assert sd["state"][k]["v"].tobytes() == st["v"].tobytes()
    # a resume elsewhere: the moments come back from the dict
    other = NVMeAdam(swap_dir=str(tmp_path / "resume"), lr=1e-2, weight_decay=0.01)
    other.load_state_dict(sd)
    more_a, more_b = [p.copy() for p in ours], [p.copy() for p in ours]
    g = [np.full(s, 0.5, np.float32) for s in SHAPES]
    port.step(more_a, g)
    other.step(more_b, g)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(more_a, more_b))
    port.swapper.close()
    other.swapper.close()


@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "adam-l2"])
def test_cpu_adam_matches_fused_adam_plain(adamw):
    """Within JAX's ``test_cpu_adam_matches_optax`` tolerance."""
    rng = np.random.default_rng(6)
    p0 = rng.normal(size=2053).astype(np.float32)
    host = DeepSpeedCPUAdam(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01,
                            adamw_mode=adamw)
    p_host = [p0.copy()]
    p_dev = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    fused = FusedAdam([p_dev], lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01,
                      adam_w_mode=adamw)
    for _ in range(5):
        g = rng.normal(size=2053).astype(np.float32)
        host.step(p_host, [g.copy()])
        p_dev.grad = torch.from_numpy(g.copy())
        fused.step()
        np.testing.assert_allclose(p_host[0], p_dev.detach().numpy(), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("use_direct", [False, True], ids=["buffered", "o_direct"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_aio_files_cross_between_the_packages(tmp_path, writer, use_direct):
    rng = np.random.default_rng(7)
    # past one 8 MB bounce chunk with an unaligned tail, and one below a sector
    bufs = [rng.integers(0, 255, size=9 * 1024 * 1024 + 1234, dtype=np.uint8),
            rng.normal(size=100).astype(np.float32), rng.normal(size=5000).astype(np.float32)]
    write = (AsyncIOHandle if writer == "port" else JaxAIO)(n_threads=2, use_direct=use_direct)
    read = (JaxAIO if writer == "port" else AsyncIOHandle)(n_threads=2, use_direct=use_direct)
    for i, b in enumerate(bufs):
        write.pwrite(b, tmp_path / f"t{i}.bin")
    assert write.wait() == 0
    outs = [np.empty_like(b) for b in bufs]
    for i, o in enumerate(outs):
        read.pread(o, tmp_path / f"t{i}.bin")
    assert read.wait() == 0
    for b, o in zip(bufs, outs):
        assert b.tobytes() == o.tobytes()
    write.close()
    read.close()


def test_aio_takes_cpu_tensors_and_sync_calls(tmp_path):
    h = AsyncIOHandle(n_threads=1)
    t = torch.arange(4096, dtype=torch.float32)
    h.pwrite(t, tmp_path / "a.bin")
    assert h.wait() == 0
    back = torch.empty(4096, dtype=torch.float32)
    assert h.sync_pread(back, tmp_path / "a.bin") == 0
    assert torch.equal(back, t)
    assert h.sync_pwrite(back * 2, tmp_path / "b.bin") == 0
    arr = np.empty(4096, np.float32)
    h.pread(arr, tmp_path / "b.bin")
    assert h.wait() == 0 and np.array_equal(arr, (t * 2).numpy())
    h.close()


def test_aio_error_is_reported():
    h = AsyncIOHandle(n_threads=1)
    h.pread(np.empty(10, np.float32), "/nonexistent/path/file.bin")
    assert h.wait() == 1
    h.close()


def test_aio_direct_fallback_counter(tmp_path):
    """Buffered handles count no fallback; a sub-sector direct write always
    counts one (it cannot be O_DIRECT); a closed handle raises instead of
    reading as "none"."""
    hb = AsyncIOHandle(n_threads=1, use_direct=False)
    hb.pwrite(np.arange(8192, dtype=np.uint8), tmp_path / "b.bin")
    assert hb.wait() == 0 and hb.direct_fallbacks() == 0
    hb.close()
    with pytest.raises(RuntimeError, match="closed"):
        hb.direct_fallbacks()
    h = AsyncIOHandle(n_threads=2, use_direct=True)
    h.pwrite(np.arange(8192, dtype=np.uint8), tmp_path / "x.bin")
    assert h.wait() == 0
    before = h.direct_fallbacks()
    h.pwrite(np.arange(100, dtype=np.uint8), tmp_path / "tiny.bin")
    assert h.wait() == 0
    assert h.direct_fallbacks() == before + 1
    h.close()


def test_host_libraries_build_from_the_port_sources():
    for builder in (CPUAdamBuilder(), AsyncIOBuilder()):
        for src in builder.absolute_sources():
            assert src.parent == HOST_CSRC_DIR and src.is_file()
        lib = builder.load()
        assert os.path.dirname(lib._name) == str(HOST_BUILD_DIR)
        assert os.path.basename(lib._name).startswith(f"lib{builder.NAME}-")
    assert "-mavx2" in CPUAdamBuilder().cxx_args() and "-march=native" in AsyncIOBuilder().cxx_args()


def test_a_failed_host_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler that fails makes the build raise."""
    import deepspeed_tpu_torch.ops.op_builder as ob
    monkeypatch.setattr(ob, "HOST_BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="build of host library cpu_adam failed"):
        CPUAdamBuilder().build()
