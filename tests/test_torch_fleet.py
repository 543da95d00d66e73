"""The PyTorch port's serving fleet against the JAX package's.

Both packages serve the same seeded GPT-2 ``test`` weights (2 layers,
``n_positions`` 128, carried over with ``params_from_jax``) in fp32 on the
CPU, the port on its flash backend (K3's plain version, int8 KV). The same
scripts drive both: the wire bytes, the router's accounting on stub
replicas (``stats()`` equal), a SIGTERM migration between two
``LocalReplica`` schedulers (tokens equal to JAX's uninterrupted run and to
JAX's fleet run, the exported fp32 KV rows within 1e-5 of JAX's), a
SIGKILL's re-admission, the refusals, the autoscaler's decisions, and
bundles crossing between the packages in both directions.
"""

import json
import os
import time

import numpy as np
import pytest

import flax.linen as nn
import jax
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import fleet as jax_fleet
from deepspeed_tpu.inference.fleet import migrate as jax_migrate
from deepspeed_tpu.inference.fleet import protocol as jax_protocol
from deepspeed_tpu.inference.serving import (ContinuousBatchingScheduler as JaxScheduler,
                                             Request as JaxRequest, ServingConfig as JaxServingConfig)
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.inference import fleet
from deepspeed_tpu_torch.inference.fleet import (AutoscalePolicy, Autoscaler, FleetRouter,
                                                 LocalReplica, load_bundle, make_bundle_migrate,
                                                 protocol, receive_bundle, save_bundle)
from deepspeed_tpu_torch.inference.fleet.migrate import bundle_rids, leaf_key
from deepspeed_tpu_torch.models.common import flatten_tree
from deepspeed_tpu_torch.inference.serving import (MIGRATABLE_STATES, SERVE_EVENT_SCHEMAS,
                                                   ContinuousBatchingScheduler, MigrationError,
                                                   Request, ServingConfig, iter_serve_events,
                                                   validate_event)
from deepspeed_tpu_torch.runtime.resilience.faults import bitflip_file
from deepspeed_tpu_torch.runtime.telemetry import TELEMETRY_FILE, RuntimeTelemetry, TelemetryConfig

N_LAYER, POSITIONS, NEW = 2, 128, 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class SimClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt: float = 1.0):
        self.t += dt


def _prompts(n, length=10, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (length,)).astype(np.int32) for _ in range(n)]


PROMPTS = _prompts(6)


def _spread(tree, seed=3):
    """The tree with every float leaf re-drawn N(0, 0.15) (norm scales
    around 1), seeded: under the init's 0.02 a 2-layer model repeats one
    token, and a migration that restored the wrong rows could not show."""
    rng = np.random.default_rng(seed)
    flat = flatten_tree(tree, "/")
    out = {}
    for key in sorted(flat):
        leaf = np.asarray(flat[key])
        node = out
        *scopes, name = key.split("/")
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[name] = ((1.0 + rng.normal(0, 0.1, leaf.shape)) if name == "scale"
                      else rng.normal(0, 0.15, leaf.shape)).astype(leaf.dtype)
    return out


def _drive_sigterm(router, replicas, bundle_dir):
    """The JAX test's script: 6 requests over two replicas, 3 router steps,
    SIGTERM the first replica, run to completion."""
    rids = [router.submit(p, NEW) for p in PROMPTS]
    for _ in range(3):
        router.step()
    assert len(replicas[0].scheduler.in_flight) >= 1  # the signal lands mid-flight
    replicas[0].sigterm(bundle_dir)
    router.run_until_complete(max_rounds=2000)
    return [router.completed[rid]["output"] for rid in rids]


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX engine, its uninterrupted tokens, and its fleet's SIGTERM run
    (tokens, router stats, the bundle it published)."""
    set_topology(None)
    cfg = jax_config("test", n_layer=N_LAYER, n_positions=POSITIONS)
    module = JaxGPT2(cfg)
    tree = _spread(jax.device_get(nn.meta.unbox(
        jax.jit(module.init)(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"])))
    topo = MeshTopology(tensor=1, data=1, fsdp=1, devices=jax.devices()[:1])
    engine = JaxEngine(module, JaxInferenceConfig(replace_with_kernel_inject=False), params=tree,
                       topology=topo)

    def sched():
        return JaxScheduler(engine, JaxServingConfig(slots=4, prefill_chunk=8, kv_quant=True))

    ref = sched()
    reqs = [JaxRequest(prompt=p, max_new_tokens=NEW) for p in PROMPTS]
    for r in reqs:
        ref.submit(r)
    ref.run_until_drained()
    router = jax_fleet.FleetRouter()
    replicas = [jax_fleet.LocalReplica(f"r{i}", sched()) for i in range(2)]
    for r in replicas:
        router.add_replica(r.name, r)
    bundle = str(tmp_path_factory.mktemp("jax_fleet") / "bundle")
    outputs = _drive_sigterm(router, replicas, bundle)
    yield dict(tree=tree, ref=[list(r.output) for r in reqs], outputs=outputs,
               stats=router.stats(), bundle=bundle)
    set_topology(None)


@pytest.fixture(scope="module")
def engine(jax_side):
    """The port's engine on JAX's weights, flash backend, on the CPU."""
    state = params_from_jax(jax_side["tree"])
    model = GPT2LMHeadModel(get_gpt2_config("test", n_layer=N_LAYER, n_positions=POSITIONS),
                            device="cpu")
    return init_inference(model, params=state, device="cpu", kernel_inject=True,
                          use_flash_prefill=True)


def _sched(engine, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("kv_quant", True)
    telemetry = kw.pop("telemetry", None)
    return ContinuousBatchingScheduler(engine, ServingConfig(**kw), telemetry=telemetry)


@pytest.fixture(scope="module")
def port_fleet(engine, tmp_path_factory):
    """The port's fleet under the JAX test's SIGTERM script, each replica
    with telemetry on."""
    tdir = tmp_path_factory.mktemp("port_fleet")
    router = FleetRouter()
    telem = [RuntimeTelemetry(TelemetryConfig(enabled=True, output_path=str(tdir), job_name=f"r{i}"))
             for i in range(2)]
    replicas = [LocalReplica(f"r{i}", _sched(engine, telemetry=telem[i], tick_telemetry_every=1))
                for i in range(2)]
    for r in replicas:
        router.add_replica(r.name, r)
    bundle = str(tdir / "bundle")
    outputs = _drive_sigterm(router, replicas, bundle)
    for t in telem:
        t.close()
    return dict(outputs=outputs, stats=router.stats(), bundle=bundle, replicas=replicas,
                files=[os.path.join(t.run_dir, TELEMETRY_FILE) for t in telem])


def _midflight(engine, n=2, **kw):
    sched = _sched(engine, **kw)
    for p in _prompts(n, seed=23):
        sched.submit(Request(prompt=p, max_new_tokens=NEW))
    for _ in range(3):
        sched.step()
    assert sched.in_flight
    return sched


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

WIRE = [jax_protocol.request_msg("r7", np.arange(4, dtype=np.int32), 8, None),
        jax_protocol.request_msg("r8", [5, 6], 3, 50256),
        {"type": "migrate_in", "bundle": "/b/x"}, {"type": "stop"},
        {"type": "ready", "pid": 12, "slots": 4, "capacity": 128},
        {"type": "tick", "signals": {"queue_depth": 1, "ttft_p99": None, "prefix_hot": ["ab"]}},
        {"type": "done", "rid": "r1", "output": [1, 2], "stats": {"ttft": 0.5}},
        {"type": "migrated_in", "rids": ["r1"], "refused_rids": [None]}]
NOISE = ["", "W0000 gemm autotune fallback", '{"type": "tick", "sig', "[1, 2, 3]", '{"rid": 1}',
         "  " + jax_protocol.encode({"type": "bye", "exit": 143})]


def test_protocol_bytes_equal_jax():
    for msg in WIRE:
        assert protocol.encode(msg) == jax_protocol.encode(msg)
    assert protocol.request_msg("r7", np.arange(4, dtype=np.int32), 8) == WIRE[0]
    for line in NOISE + [jax_protocol.encode(m) for m in WIRE]:
        assert protocol.parse_line(line) == jax_protocol.parse_line(line)
    assert protocol.parse_lines(NOISE) == jax_protocol.parse_lines(NOISE)
    assert (protocol.WORKER_KINDS, protocol.ROUTER_KINDS) == (jax_protocol.WORKER_KINDS,
                                                              jax_protocol.ROUTER_KINDS)
    with pytest.raises(ValueError):
        protocol.encode({"rid": "no-type"})


def test_fleet_exports_jax_names():
    assert sorted(fleet.__all__) == sorted(jax_fleet.__all__)
    assert MIGRATABLE_STATES == ("prefill", "active")


# ---------------------------------------------------------------------------
# the router on stub replicas: the same script through both routers
# ---------------------------------------------------------------------------

class StubReplica:
    def __init__(self, load=0.0, refuse=False, age=None):
        self._load = load
        self.refuse = refuse
        self.dead = False
        self.inbox, self.outbox = [], []
        if age is not None:
            self.heartbeat_age = lambda: age

    @property
    def alive(self):
        return not self.dead

    def load(self):
        return float("inf") if self.dead else self._load

    def send(self, msg):
        if self.dead:
            raise RuntimeError("dead")
        self.inbox.append(msg)
        if msg["type"] == "request":
            if self.refuse:
                self.outbox.append({"type": "refused", "rid": msg["rid"], "reason": "stub refuses"})
            else:
                self._load += 1

    def poll(self):
        out, self.outbox = self.outbox, []
        return out

    def finish(self, rid, output=(1, 2)):
        self._load = max(0.0, self._load - 1)
        self.outbox.append({"type": "done", "rid": rid, "output": list(output), "stats": {}})


def _dispatch_and_dedupe(router_cls):
    router = router_cls()
    busy, idle = StubReplica(load=3.0), StubReplica(load=0.0)
    router.add_replica("busy", busy)
    router.add_replica("idle", idle)
    rid = router.submit(np.arange(3, dtype=np.int32), 4)
    first = router.pending[rid]["replica"]
    idle.finish(rid, output=(9, 9))
    router.poll()
    busy.outbox.append({"type": "done", "rid": rid, "output": [0], "stats": {}})
    router.poll()
    return dict(first=first, inboxes=(len(busy.inbox), len(idle.inbox)),
                delivered=router.completed[rid]["output"], stats=router.stats())


def _universal_refusal(router_cls):
    router = router_cls()
    router.add_replica("a", StubReplica(refuse=True))
    router.add_replica("b", StubReplica(refuse=True))
    rid = router.submit(np.arange(3, dtype=np.int32), 4)
    polls = 0
    while rid not in router.failed and polls < 20:  # bounded retries: no ping-pong
        router.poll()
        polls += 1
    return dict(polls=polls, failed=dict(router.failed), stats=router.stats())


def _death_readmits(router_cls):
    router = router_cls()
    doomed, survivor = StubReplica(load=0.0), StubReplica(load=5.0)
    router.add_replica("doomed", doomed)
    router.add_replica("survivor", survivor)
    rid = router.submit(np.arange(3, dtype=np.int32), 4)
    first = router.pending[rid]["replica"]
    doomed.dead = True  # SIGKILL: no drain, no messages
    router.poll()
    after = (router.pending[rid]["replica"], sorted(router.replicas))
    survivor.finish(rid)
    router.poll()
    return dict(first=first, after=after, stats=router.stats())


def _heartbeat_staleness(router_cls):
    router = router_cls(heartbeat_timeout=5.0)
    router.add_replica("wedged", StubReplica(age=60.0))
    router.add_replica("fresh", StubReplica(load=2.0, age=0.1))
    alive = sorted(router.alive_replicas())
    rid = router.submit(np.arange(3, dtype=np.int32), 4)
    return dict(alive=alive, chosen=router.pending[rid]["replica"], stats=router.stats())


@pytest.mark.parametrize("script", [_dispatch_and_dedupe, _universal_refusal, _death_readmits,
                                    _heartbeat_staleness], ids=lambda f: f.__name__.strip("_"))
def test_router_accounting_matches_jax(script):
    got, want = script(FleetRouter), script(jax_fleet.FleetRouter)
    assert got == want
    if script is _dispatch_and_dedupe:
        assert got["first"] == "idle" and got["delivered"] == [9, 9]
        assert got["stats"]["duplicate_completions"] == 1 and got["stats"]["pending"] == 0
    elif script is _universal_refusal:
        assert got["failed"] and got["stats"]["pending"] == 0
    elif script is _death_readmits:
        assert got["after"] == ("survivor", ["survivor"]) and got["stats"]["readmitted"] == 1
    else:
        assert got["alive"] == ["fresh"] and got["chosen"] == "fresh"


# ---------------------------------------------------------------------------
# live migration between LocalReplicas
# ---------------------------------------------------------------------------

def test_sigterm_migration_gives_jax_tokens(jax_side, port_fleet):
    """Every continuation after the SIGTERM equals JAX's uninterrupted run
    and JAX's own fleet run; the router's accounting equals JAX's."""
    assert port_fleet["outputs"] == jax_side["ref"]
    assert len({t for out in jax_side["ref"] for t in out}) > 12  # the tokens vary
    assert port_fleet["outputs"] == jax_side["outputs"]
    st = port_fleet["stats"]
    assert st == jax_side["stats"]
    assert st["completed"] == len(PROMPTS) and st["failed"] == 0 and st["pending"] == 0
    assert st["duplicate_completions"] == 0
    migrated = [r for r in port_fleet["replicas"][1].scheduler.finished if "migrated_from" in r.meta]
    assert migrated and all(r.meta["fleet_rid"] for r in migrated)
    assert port_fleet["replicas"][0].exit_code == 143


def test_migration_events_validate(port_fleet):
    kinds = []
    for path in port_fleet["files"]:
        for rec in iter_serve_events(path):
            validate_event(rec)
            kinds.append(rec["event"])
    assert kinds.count("serve_migrate_in") == 1 and kinds.count("serve_admit_migrated") >= 1
    assert {"serve_migrate_out", "serve_migrate_in", "serve_admit_migrated"} <= set(SERVE_EVENT_SCHEMAS)


def test_exported_rows_match_jax_bundle(jax_side, port_fleet):
    """The two fleets exported the same requests at the same lengths, the
    int8 codes equal and the fp32 scales within 1e-5; the JAX package reads
    and verifies the port's bundle."""
    mine = jax_migrate.load_bundle(port_fleet["bundle"])  # JAX verifies the port's digests
    theirs = jax_migrate.load_bundle(jax_side["bundle"])
    assert [p["length"] for p in mine] == [p["length"] for p in theirs]
    assert [p["output"] for p in mine] == [p["output"] for p in theirs]
    for a, b in zip(mine, theirs):
        assert set(a["kv"]["target"]) == set(b["kv"]["target"])
        for key, rows in b["kv"]["target"].items():
            got = a["kv"]["target"][key]
            assert got.shape == rows.shape and got.dtype == rows.dtype
            if rows.dtype == np.int8:
                np.testing.assert_array_equal(got, rows)
            else:
                np.testing.assert_allclose(got, rows, rtol=0, atol=1e-5)
    with open(os.path.join(port_fleet["bundle"], "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(jax_side["bundle"], "manifest.json")) as f:
        jax_manifest = json.load(f)
    assert set(manifest) == set(jax_manifest) and manifest["kind"] == "kv_migration_bundle"

    def leaves_by_request(man, payloads):  # request ids are each process's own counts
        return [{k[len(f"[{str(p['request_id'])!r}]"):]: v["shape"] for k, v in man["leaves"].items()
                 if k.startswith(f"[{str(p['request_id'])!r}]")} for p in payloads]
    assert leaves_by_request(manifest, mine) == leaves_by_request(jax_manifest, theirs)


def test_jax_bundle_restores_into_the_port(jax_side, engine):
    """A bundle JAX's worker published is verified and admitted by the
    port's scheduler, and every restored request continues to JAX's
    uninterrupted tokens."""
    payloads = load_bundle(jax_side["bundle"])
    sched = _sched(engine)
    admitted, refused = receive_bundle(sched, jax_side["bundle"])
    assert len(admitted) == len(payloads) and not refused
    for req, p in zip(admitted, payloads):
        assert req.meta["migrated_from"] == p["request_id"]
        slot = next(i for i, r in enumerate(sched._slot_req) if r is req)
        for name, rows in p["kv"]["target"].items():
            assert torch.equal(sched._cache[name][slot, :p["length"]], rows)
    sched.run_until_drained()
    by_rid = {rid: out for rid, out in zip(["r%d" % i for i in range(len(PROMPTS))], jax_side["ref"])}
    for req in admitted:
        assert req.output == by_rid[req.meta["fleet_rid"]]


def test_sigkill_readmits_at_most_once(jax_side, engine):
    router = FleetRouter()
    replicas = [LocalReplica(f"k{i}", _sched(engine)) for i in range(2)]
    for r in replicas:
        router.add_replica(r.name, r)
    rids = [router.submit(p, NEW) for p in PROMPTS]
    for _ in range(2):
        router.step()
    victim = replicas[0] if replicas[0].scheduler.in_flight else replicas[1]
    victim.sigkill()
    router.run_until_complete(max_rounds=2000)
    st = router.stats()
    assert st["completed"] == len(PROMPTS) and st["failed"] == 0 and st["readmitted"] >= 1, st
    assert st["duplicate_completions"] == 0
    assert [router.completed[rid]["output"] for rid in rids] == jax_side["ref"]


def test_sigterm_with_no_peer_then_late_replica(jax_side, engine, tmp_path):
    """A lone replica's SIGTERM publishes its bundle with no peer to take
    it: the replica exits 143, nothing is dropped, and a replica that
    arrives later finishes every request with JAX's tokens."""
    router = FleetRouter()
    solo = LocalReplica("solo", _sched(engine))
    router.add_replica("solo", solo)
    rids = [router.submit(p, NEW) for p in PROMPTS[:2]]
    for _ in range(2):
        router.step()
    solo.sigterm(str(tmp_path / "bundle"))
    router.poll()
    assert solo.exit_code == 143
    assert all(rid in router.pending for rid in rids if rid not in router.completed)
    router.add_replica("late", LocalReplica("late", _sched(engine)))
    for rid in list(router.pending):
        if router.pending[rid]["replica"] is None:
            router.dispatch(rid)
    router.run_until_complete(max_rounds=2000)
    assert router.stats()["completed"] == 2 and router.stats()["failed"] == 0
    assert [router.completed[rid]["output"] for rid in rids] == jax_side["ref"][:2]


@pytest.mark.parametrize("hook", ["bundle", "refused"])
def test_serve_migrate_hook_or_drain_returns_143(engine, tmp_path, hook):
    """``serve(migrate=)`` on a signal: a hook that publishes the bundle
    ends the loop with the work exported (``serve_migrate_out``); a hook
    that raises ``MigrationError`` leaves the drain to finish the work here.
    Both return 143."""
    telem = RuntimeTelemetry(TelemetryConfig(enabled=True, output_path=str(tmp_path), job_name="s"))
    sched = _sched(engine, telemetry=telem, do_sample=hook == "refused", temperature=0.8)

    class Guard:
        requested = False

        def consume(self):
            return "SIGTERM"

    guard = Guard()
    reqs = [Request(prompt=p, max_new_tokens=NEW) for p in _prompts(6, seed=7)]
    for r in reqs:
        sched.submit(r)
    sched.step()
    guard.requested = True
    bundle = str(tmp_path / "bundle")
    assert sched.serve(guard=guard, migrate=make_bundle_migrate(bundle)) == 143
    telem.close()
    events = [r["event"] for r in iter_serve_events(os.path.join(telem.run_dir, TELEMETRY_FILE))]
    assert events.count("serve_drain") == 1
    assert sched.pool.used_blocks == 0 and not sched.in_flight
    if hook == "bundle":
        assert events.count("serve_migrate_out") == 1
        assert len(load_bundle(bundle)) == 4 and not sched.finished
    else:
        assert "serve_migrate_out" not in events and not os.path.exists(bundle)
        assert len(sched.finished) == 4 and all(len(r.output) == NEW for r in sched.finished)


# ---------------------------------------------------------------------------
# refusals: corruption, sampling, compat and capacity
# ---------------------------------------------------------------------------

def test_bit_flipped_bundle_is_refused_loudly(engine, tmp_path):
    sched = _midflight(engine)
    payloads = sched.export_inflight(release=False)
    bundle = save_bundle(payloads, str(tmp_path / "bundle"))
    sched.release_inflight()
    assert bundle_rids(load_bundle(bundle)) == bundle_rids(payloads)
    victim = sorted(f for f in os.listdir(bundle) if f.endswith(".npz"))[0]
    bitflip_file(os.path.join(bundle, victim), seed=1)
    with pytest.raises(MigrationError, match="integrity"):
        load_bundle(bundle)
    receiver = _sched(engine)
    with pytest.raises(MigrationError):
        receive_bundle(receiver, bundle)
    assert not receiver.in_flight and receiver.pool.used_blocks == 0


def test_sampled_decoding_refuses_to_migrate(engine):
    sched = _midflight(engine, do_sample=True, temperature=0.8)
    inflight = len(sched.in_flight)
    with pytest.raises(MigrationError, match="sampled decoding"):
        sched.export_inflight()
    assert len(sched.in_flight) == inflight  # untouched: still drainable
    sched.run_until_drained()
    assert not sched.in_flight


def test_compat_mismatch_raises_capacity_shortfall_returns_none(engine):
    src = _midflight(engine)
    payloads = src.export_inflight(release=False)
    fp_receiver = _sched(engine, kv_quant=False)
    with pytest.raises(MigrationError, match="kv_quant"):
        fp_receiver.admit_migrated(payloads[0])
    with pytest.raises(MigrationError, match="prefix_cache"):
        _sched(engine, prefix_cache="off").admit_migrated(payloads[0])
    bad = dict(payloads[0], kv={"target": dict(payloads[0]["kv"]["target"])})
    bad["kv"]["target"].pop(next(iter(bad["kv"]["target"])))
    receiver = _sched(engine)
    with pytest.raises(MigrationError, match="missing"):
        receiver.admit_migrated(bad)
    assert not receiver.in_flight and receiver.pool.used_blocks == 0  # untouched
    full = _midflight(engine, n=4)
    assert len(full.in_flight) == 4
    assert full.admit_migrated(payloads[0]) is None
    src.release_inflight()
    assert src.pool.used_blocks == 0


# ---------------------------------------------------------------------------
# the autoscaler: the same signals through both, the same decisions
# ---------------------------------------------------------------------------

def _sig(queue=0, in_flight=0, slots=4, ttft=None, frag=0):
    return {"queue_depth": queue, "in_flight": in_flight, "slots": slots, "ttft_p99": ttft,
            "pool_fragmentation_tokens": frag}


def _hysteresis(mod):
    clock = SimClock()
    a = mod.Autoscaler(mod.AutoscalePolicy(max_replicas=3, queue_high=2.0, scale_up_cooldown_s=10.0,
                                           scale_down_cooldown_s=10.0, flap_guard_s=5.0), clock=clock)
    hot, cold = {"a": _sig(queue=5, in_flight=4)}, {"a": _sig(), "b": _sig()}
    out = [(a.decide({}), a.last_reason), (a.decide(hot), a.last_reason), (a.decide(hot), a.last_reason)]
    clock.advance(11.0)
    out.append((a.decide(hot), a.last_reason))
    clock.advance(2.0)
    out.append((a.decide(cold), a.last_reason))
    clock.advance(20.0)
    out.append((a.decide(cold), a.last_reason))
    absorb = mod.Autoscaler(mod.AutoscalePolicy(occupancy_low=0.9, scale_down_cooldown_s=0.0,
                                                flap_guard_s=0.0), clock=SimClock())
    out.append((absorb.decide({"a": _sig(in_flight=3), "b": _sig(in_flight=3)}, now=1.0),
                absorb.last_reason))
    clock.advance(20.0)
    out.append((a.decide({"a": _sig()}), a.last_reason))
    out.append((a.decide({n: _sig(queue=9) for n in "abc"}), a.last_reason))
    return out, a.decisions


def _triggers(mod):
    out = []
    for policy, sig in ((dict(ttft_p99_high=0.5, frag_tokens_high=100), _sig(ttft=0.9)),
                        (dict(frag_tokens_high=100), _sig(frag=500))):
        a = mod.Autoscaler(mod.AutoscalePolicy(scale_up_cooldown_s=0.0, flap_guard_s=0.0, **policy),
                           clock=SimClock())
        out.append((a.decide({"a": sig}, now=1.0), a.last_reason, a.decisions))
    return out


@pytest.mark.parametrize("script", [_hysteresis, _triggers], ids=lambda f: f.__name__.strip("_"))
def test_autoscaler_decisions_match_jax(script):
    got, want = script(fleet), script(jax_fleet)
    assert got == want
    if script is _hysteresis:
        assert [d["delta"] for d in got[1]] == [+1, +1, -1]


def test_autoscaler_offline_replay_matches_jax(tmp_path):
    """Each package's replicas write serve_tick lines; each package's replay
    reads the newest of either package's files, and decides as JAX does."""
    from deepspeed_tpu.runtime.config import TelemetryConfig as JaxTelemetryConfig
    from deepspeed_tpu.runtime.telemetry import RuntimeTelemetry as JaxTelemetry
    paths = {}
    for name, queue, telem_cls, cfg_cls in (("hot", 8, RuntimeTelemetry, TelemetryConfig),
                                            ("warm", 6, JaxTelemetry, JaxTelemetryConfig)):
        t = telem_cls(cfg_cls(enabled=True, output_path=str(tmp_path), job_name=name))
        t.write_run_header({"bench": "test"})
        t.emit("serve_tick", tick=1, kind="decode", **_sig(queue=0), free_slots=4, ttft_p50=None)
        t.emit("serve_tick", tick=2, kind="decode", **_sig(queue=queue, in_flight=4), free_slots=0,
               ttft_p50=None)
        t.close()
        paths[name] = os.path.join(t.run_dir, TELEMETRY_FILE)
    sigs = Autoscaler.signals_from_telemetry(paths)
    assert sigs == jax_fleet.Autoscaler.signals_from_telemetry(paths)
    assert sigs["hot"]["queue_depth"] == 8 and sigs["warm"]["queue_depth"] == 6
    decisions = []
    for mod in (fleet, jax_fleet):
        a = mod.Autoscaler(mod.AutoscalePolicy(queue_high=4.0, scale_up_cooldown_s=0.0,
                                               flap_guard_s=0.0), clock=SimClock())
        decisions.append((a.decide(sigs, now=1.0), a.decisions))
    assert decisions[0] == decisions[1] and decisions[0][0] == +1


def test_bf16_rows_travel_as_jax_writes_them(tmp_path):
    """A bf16 leaf lands as numpy lands JAX's bf16 arrays (two raw bytes,
    ``|V2``; ``bfloat16`` in the manifest) and comes back bit for bit."""
    rows = torch.randn(5, 4, 16).to(torch.bfloat16)
    payload = dict(request_id=3, state="active", prompt=np.arange(4, dtype=np.int32),
                   max_new_tokens=2, eos_token_id=None, arrival_time=0.0, output=[1],
                   prefill_pos=4, first_token_time=0.5, token_times=[0.5], drafted_tokens=0,
                   accepted_tokens=0, meta={"fleet_rid": "r0"}, length=5, next_token=1,
                   kv_quant=False, weight_dtype="fp", capacity=128, spec_k=0,
                   cached_prefix_tokens=0, prefix_cache="on",
                   kv={"target": {"h_0/attn/cached_key": rows}})
    bundle = save_bundle([payload], str(tmp_path / "bundle"))
    with np.load(os.path.join(bundle, "req_3.npz")) as npz:
        assert npz["target::['h_0']['attn']['cached_key']"].dtype == np.dtype("V2")
    with open(os.path.join(bundle, "manifest.json")) as f:
        (entry,) = json.load(f)["leaves"].values()
    assert entry["dtype"] == "bfloat16" and entry["shape"] == [5, 4, 16]
    (back,) = load_bundle(bundle)
    got = back["kv"]["target"]["h_0/attn/cached_key"]
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16), rows.view(torch.int16))
    assert {k: back[k] for k in ("output", "meta", "length")} == \
        {"output": [1], "meta": {"fleet_rid": "r0"}, "length": 5}


def test_leaf_keys_are_jax_keystr():
    assert leaf_key("h_0/attn/cached_key") == "['h_0']['attn']['cached_key']"
    assert leaf_key("h_1/attn/cached_value_scale") == jax.tree_util.keystr(
        (jax.tree_util.DictKey("h_1"), jax.tree_util.DictKey("attn"),
         jax.tree_util.DictKey("cached_value_scale")))


# ---------------------------------------------------------------------------
# real processes (the card's round trip: tests/test_torch_fleet_cuda.py)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_subprocess_fleet_smoke(tmp_path):
    """Two worker processes behind the router on the CPU: requests complete
    over the pipes, a real SIGTERM migrates the in-flight work to the peer
    (exit 143), nothing is dropped, and the tokens equal an in-process run
    of the same knobs."""
    from deepspeed_tpu_torch.inference.fleet import SubprocessReplica
    from deepspeed_tpu_torch.inference.fleet.worker import build_scheduler
    env = {"FLEET_DEVICE": "cpu", "FLEET_MODEL": "test", "FLEET_POSITIONS": "128",
           "FLEET_SLOTS": "4", "FLEET_CHUNK": "8", "FLEET_TELEMETRY_DIR": str(tmp_path / "telemetry")}
    prompts = [np.random.default_rng(0).integers(0, 256, (10,)).astype(np.int32) for _ in range(6)]
    ref_sched, _ = build_scheduler({k: v for k, v in env.items() if k != "FLEET_TELEMETRY_DIR"})
    reqs = [Request(prompt=p, max_new_tokens=NEW) for p in prompts]
    for r in reqs:
        ref_sched.submit(r)
    ref_sched.run_until_drained()
    router = FleetRouter(heartbeat_timeout=120.0)
    replicas = [SubprocessReplica(f"w{i}", str(tmp_path / f"w{i}"), env=env) for i in range(2)]
    try:
        for r in replicas:
            r.wait_ready(timeout=300.0)
            router.add_replica(r.name, r)
        rids = [router.submit(p, NEW) for p in prompts]
        deadline = time.monotonic() + 300.0
        termed = False
        while router.pending and time.monotonic() < deadline:
            router.poll()
            sig = replicas[0].signals()
            if not termed and replicas[0].alive and sig and sig.get("in_flight", 0) > 0:
                replicas[0].sigterm()
                termed = True
            time.sleep(0.02)
        st = router.stats()
        assert st["completed"] == len(prompts) and st["failed"] == 0, (st, router.failed)
        assert termed and replicas[0].wait(60.0) == 143
        assert [router.completed[rid]["output"] for rid in rids] == [r.output for r in reqs]
    finally:
        for r in replicas:
            r.close()
