"""``DSElasticAgent`` supervising a CPU child of the port, as JAX's
``tests/unit/elasticity/test_elastic_agent.py:102-212`` supervises a JAX
child: a child killed by ``DS_FAULT_SPEC=step=sigkill@2`` restarts and
resumes to losses bit-equal to an uninterrupted run (tolerance 0), a child
hung by ``DS_FAULT_SPEC=step=hang@2`` is declared silent, killed and
restarted, each history row carries its topology (``fresh``, then
``plain`` at one card) and the child's last heartbeat, and
``validate_world_sizes`` refuses a ladder the elastic batch plan does not
admit. Four child processes, GPT-2 "test" (2 layers) on the CPU.
"""

import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.elasticity.elastic_agent import DSElasticAgent as JaxAgent
from deepspeed_tpu_torch.elasticity import DSElasticAgent, ElasticityIncompatibleWorldSize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4

# The supervised job: the port's engine on the CPU, one intra-op thread,
# per-step seeded batches, a synchronous save and a heartbeat every step.
# FIRST_FAULT arms DS_FAULT_SPEC on the first launch only.
CHILD = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, __REPO__)
    if os.environ.get("DS_ELASTIC_RESTART_COUNT", "0") == "0":
        os.environ["DS_FAULT_SPEC"] = os.environ.get("FIRST_FAULT", "")
    import numpy as np, torch
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as ds
    world = int(os.environ["DS_ELASTIC_WORLD_SIZE"])
    assert world == 1, world
    ckpt, losses = os.environ["CKPT_DIR"], os.environ["LOSSES_PATH"]
    model = ds.GPT2LMHeadModel(ds.get_gpt2_config("test"), device="cpu")
    engine = ds.initialize(model=model, device="cpu", config={
        "train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "resilience": {"heartbeat_interval": 0}})[0]
    engine.resume(ckpt)
    while engine.global_steps < __STEPS__:
        step = engine.global_steps
        ids = np.random.default_rng(1000 + step).integers(0, 256, (8, 16)).astype(np.int32)
        loss = float(engine.train_batch(ids))
        with open(losses, "a") as f:
            f.write(json.dumps({"step": step, "loss": loss}) + "\\n")
        engine.save_checkpoint(ckpt)
""").replace("__REPO__", repr(REPO)).replace("__STEPS__", str(STEPS))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the child takes: the shapes are tiny, the
    suite's parallel workers share the host's cores, and a bit-equal
    comparison across processes needs the same reduction split."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _uninterrupted_losses():
    model = deepspeed_tpu_torch.GPT2LMHeadModel(deepspeed_tpu_torch.get_gpt2_config("test"),
                                                device="cpu")
    engine = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})[0]
    return [float(engine.train_batch(np.random.default_rng(1000 + s).integers(
        0, 256, (8, 16)).astype(np.int32))) for s in range(STEPS)]


def _run_agent(tmp_path, first_fault, heartbeat_timeout=60.0):
    child = tmp_path / "child.py"
    child.write_text(CHILD)
    losses, ckpt = tmp_path / "losses.jsonl", tmp_path / "ckpt"
    restarts = []
    env = {"CKPT_DIR": str(ckpt), "LOSSES_PATH": str(losses), "FIRST_FAULT": first_fault,
           "OMP_NUM_THREADS": "1"}
    agent = DSElasticAgent([sys.executable, str(child)], world_sizes=[1],
                           heartbeat_timeout=heartbeat_timeout, max_restarts=2, env=env,
                           poll_interval=0.1, checkpoint_dir=str(ckpt),
                           on_restart=lambda n, w: restarts.append((n, w)))
    rc = agent.run(workdir=str(tmp_path))
    rows = [json.loads(line) for line in losses.read_text().splitlines()]
    return rc, agent, rows, restarts


def test_crash_restarts_and_resumes_bit_equal(tmp_path):
    """SIGKILL at the step-2 boundary (after its heartbeat, before its
    save): the agent relaunches, ``resume()`` restores ``global_step1``, and
    the losses are the uninterrupted run's, bit for bit."""
    rc, agent, rows, restarts = _run_agent(tmp_path, "step=sigkill@2")
    assert rc == 0 and agent.restart_count == 1 and restarts == [(1, 1)], agent.history
    first, second = agent.history
    assert first["rc"] == -9 and second["rc"] == 0
    assert first["last_heartbeat"]["global_step"] == 2  # the heartbeat precedes the fault point
    assert first["last_heartbeat"]["world_size"] == 1 and first["last_heartbeat"]["mesh_axes"] is None
    assert second["last_heartbeat"]["global_step"] == STEPS
    assert first["topology"] == dict(prev_world_size=None, world_size=1, resume="fresh", tag=None,
                                     ckpt_world=None, ckpt_axes=None)
    assert second["topology"] == dict(prev_world_size=1, world_size=1, resume="plain",
                                      tag="global_step1", ckpt_world=1, ckpt_axes=None)
    assert json.dumps(agent.history)  # rows stay JSON
    # the killed step returned no loss; the relaunch trains it again
    assert [r["step"] for r in rows] == list(range(STEPS))
    assert [r["loss"] for r in rows] == _uninterrupted_losses()
    assert not any(n.startswith(".ds_elastic_heartbeat") for n in os.listdir(tmp_path))


def test_hang_is_detected_killed_and_restarted(tmp_path):
    """``step=hang@2``: the heartbeat goes silent after step 2's touch; the
    agent kills the child after ``heartbeat_timeout`` and the relaunch
    completes from ``global_step1``."""
    # The budget covers the child's longest silence that is no hang: its
    # interpreter's exit after the last heartbeat (1.3 s idle, up to 6.8 s
    # with 16 busy processes on 8 CPU cores; a step and its save
    # stay under 0.3 s), with twice that as headroom. JAX's test gives 30 s.
    rc, agent, rows, _ = _run_agent(tmp_path, "step=hang@2", heartbeat_timeout=15.0)
    assert rc == 0 and agent.restart_count == 1, agent.history
    assert "heartbeat silent" in agent.history[0]["reason"], agent.history
    assert agent.history[0]["rc"] not in (0, None)
    assert agent.history[0]["last_heartbeat"]["global_step"] == 2
    assert agent.history[1]["topology"]["resume"] == "plain"
    assert [r["step"] for r in rows] == list(range(STEPS))


def test_validate_world_sizes_refuses_a_ladder_as_jax_does():
    ds = {"elasticity": {"enabled": True, "max_train_batch_size": 8, "micro_batch_sizes": [2, 4],
                         "min_gpus": 1, "max_gpus": 4, "version": 0.1},
          "train_batch_size": 8}
    for ladder in ([4, 3], [4, 2, 1], [1], [5]):
        outcomes = []
        for cls in (JaxAgent, DSElasticAgent):
            try:
                cls(["true"], world_sizes=ladder).validate_world_sizes(ds)
                outcomes.append("ok")
            except Exception as e:  # noqa: BLE001 (compared by class name)
                outcomes.append(type(e).__name__)
        assert outcomes[0] == outcomes[1], ladder
    with pytest.raises(ElasticityIncompatibleWorldSize):
        DSElasticAgent(["true"], world_sizes=[4, 3]).validate_world_sizes(ds)
    DSElasticAgent(["true"], world_sizes=[1]).validate_world_sizes(ds)
    with pytest.raises(ValueError):
        DSElasticAgent(["true"], world_sizes=[])


def test_the_supervisor_imports_neither_torch_nor_the_engine():
    """A supervisor must stay alive when the card hangs: its modules import
    the standard library and the stamp reader only."""
    import ast
    for module in ("elasticity/elastic_agent.py", "elasticity/elasticity.py",
                   "runtime/resilience/retry.py"):
        tree = ast.parse(open(os.path.join(REPO, "deepspeed_tpu_torch", module)).read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert not {n for n in names if n.split(".")[0] == "torch" or "engine" in n}, (module, names)
