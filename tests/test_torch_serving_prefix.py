"""The port's prefix cache, byte admission, ``kv_write``, drain and
serving telemetry against the JAX package's.

The ``BlockPool`` of both packages is fed one seeded random op stream:
equal chain hashes, matches, tables, counters and raised errors after
every op. Both schedulers (GPT-2 ``test`` at 2 layers, fp32, the same
weights through ``params_from_jax``, int8 KV, the JAX one on its XLA
backend) serve the same shared-prefix traces with the cache on: the same
tokens, restored prefix lengths, prefill ticks and pool counters. Each JAX
run is shared across tests through module fixtures.
"""

import os

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.serving import (BlockPool as JaxBlockPool,
                                             ContinuousBatchingScheduler as JaxScheduler,
                                             Request as JaxRequest,
                                             SERVE_EVENT_SCHEMAS as JAX_SCHEMAS,
                                             ServingConfig as JaxServingConfig)
from deepspeed_tpu.inference.serving import blocks as jax_blocks
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.elasticity import HEARTBEAT_ENV, read_heartbeat
from deepspeed_tpu_torch.inference.serving import (FINISHED, REFUSED, SERVE_EVENT_SCHEMAS,
                                                   BlockPool, ContinuousBatchingScheduler, Request,
                                                   ServingConfig, iter_serve_events,
                                                   last_tick_signals, validate_event)
from deepspeed_tpu_torch.inference.serving import blocks
from deepspeed_tpu_torch.inference.serving.programs import (make_apply_fn, make_slot_cache,
                                                            stamp_lengths)
from deepspeed_tpu_torch.runtime.resilience.signals import (DEFAULT_PREEMPT_EXIT_CODE,
                                                            PreemptionGuard)
from deepspeed_tpu_torch.runtime.telemetry import (TELEMETRY_FILE, RuntimeTelemetry,
                                                   TelemetryConfig)


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
    """Deterministic clock: advances only when the test says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# BlockPool: one random op stream through both packages
# ---------------------------------------------------------------------------
def _outcome(fn):
    try:
        return ("ok", fn())
    except (KeyError, RuntimeError) as e:
        return (type(e).__name__, None)


def _match_view(m):
    return None if m is None else (m.cached_tokens, list(m.full_hashes), list(m.payloads),
                                   m.partial_payload, m.partial_tokens)


def _pool_view(pool):
    return (pool.counters(), {s: pool.block_table(s) for s in pool.live_sequences()},
            sorted(pool.hot_prefixes(limit=64)))


@pytest.mark.parametrize("seed", [19, 20])
def test_block_pool_op_stream_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pools = (BlockPool(24, 4, prefix_cache=True, envelope="kvq:1/wq:fp/spec:0"),
             JaxBlockPool(24, 4, prefix_cache=True, envelope="kvq:1/wq:fp/spec:0"))
    templates = [[int(t) for t in rng.integers(0, 1000, n)] for n in (8, 12, 5)]
    live, next_sid, raised = {}, 0, 0
    for _ in range(300):
        op = int(rng.integers(0, 6))
        if op <= 1 or not live:
            t = templates[int(rng.integers(0, len(templates)))]
            prompt = t + [int(x) for x in rng.integers(0, 1000, int(rng.integers(1, 9)))]
            total = len(prompt) + int(rng.integers(1, 9))
            sid, next_sid = next_sid, next_sid + 1
            probes = [(_match_view(p.match_prefix(prompt)), p.can_allocate(total, prompt=prompt))
                      for p in pools]
            assert probes[0] == probes[1]
            outs = [_outcome(lambda p=p: p.reserve(sid, total, prompt=prompt)) for p in pools]
            if outs[0][0] == "ok":
                live[sid] = prompt
                outs = [(o, _match_view(p.take_match(sid))) for o, p in zip(outs, pools)]
        elif op == 2:
            sid = int(rng.choice(list(live)))
            outs = [p.publish(sid, live[sid], fetch=lambda a, b: (a, b)) for p in pools]
        elif op == 3:
            sid = int(rng.choice(list(live)))
            outs = [_outcome(lambda p=p: p.advance(sid, 1)) for p in pools]
        elif op == 4:
            sid = int(rng.choice(list(live)))
            outs = [p.free(sid) for p in pools]
            del live[sid]
        else:  # an unknown or already freed sequence
            sid = int(rng.integers(0, next_sid + 2))
            if sid in live:
                continue
            outs = [_outcome(lambda p=p: p.free(sid)) for p in pools]
            assert outs[0][0] == "KeyError"
            raised += 1
        assert outs[0] == outs[1]
        assert _pool_view(pools[0]) == _pool_view(pools[1])
    assert raised > 0 and pools[0].prefix_hits > 0 and pools[0].prefix_evictions > 0
    for sid in list(live):
        for p in pools:
            p.free(sid)
    assert pools[0].counters() == pools[1].counters()
    assert pools[0].used_blocks == 0


def test_hashes_and_keys_match_jax():
    rng = np.random.default_rng(3)
    for envelope in ("", "kvq:1/wq:int8/spec:4"):
        parent = "root"
        for _ in range(4):
            toks = [int(t) for t in rng.integers(-5, 50000, 16)]
            h = blocks.chain_hash(parent, toks, envelope)
            assert h == jax_blocks.chain_hash(parent, toks, envelope)
            assert blocks.prefix_key(toks) == jax_blocks.prefix_key(toks)
            parent = h


def test_prefix_cache_off_is_the_private_pool():
    pool = BlockPool(8, 4, prefix_cache=False)
    p = list(range(8))
    pool.reserve(1, 8, prompt=p)
    assert pool.publish(1, p, fetch=lambda a, b: (a, b)) == 0
    assert pool.match_prefix(p).cached_tokens == 0
    pool.free(1)
    assert pool.cached_blocks == 0 and pool.free_blocks == 8
    assert pool.prefix_hits == pool.prefix_misses == 0


# ---------------------------------------------------------------------------
# the scheduler with the cache on, against JAX's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    set_topology(None)
    cfg = jax_config("test", n_layer=2)
    topo = MeshTopology(tensor=1, data=1, fsdp=1, devices=jax.devices()[:1])
    jax_engine = JaxEngine(JaxGPT2(cfg), JaxInferenceConfig(replace_with_kernel_inject=False),
                           topology=topo)
    state = params_from_jax(jax.device_get(jax_engine.params))
    port_engine = init_inference(GPT2LMHeadModel(get_gpt2_config("test", n_layer=2), device="cpu"),
                                 params=state, device="cpu")
    yield jax_engine, port_engine
    set_topology(None)


def _shared_prefix_prompts(n, template_len=24, suffix_len=6, seed=11, templates=1):
    rng = np.random.default_rng(seed)
    tmpl = [rng.integers(0, 256, template_len).astype(np.int32) for _ in range(templates)]
    return [np.concatenate([tmpl[i % templates],
                            rng.integers(0, 256, suffix_len + i % 5).astype(np.int32)])
            for i in range(n)]


SERVE_KW = dict(slots=4, prefill_chunk=8, page_size=16)


def _sequential(scheduler_cls, request_cls, engine, prompts, **kw):
    """Each prompt served to the end before the next (each publishes
    before the next matches)."""
    sched = scheduler_cls(engine, (JaxServingConfig if scheduler_cls is JaxScheduler
                                   else ServingConfig)(**SERVE_KW, **kw), clock=SimClock())
    reqs = []
    for p in prompts:
        r = request_cls(prompt=p, max_new_tokens=5)
        sched.submit(r)
        sched.run_until_drained()
        reqs.append(r)
    return sched, reqs


def _concurrent(scheduler_cls, request_cls, engine, prompts, **kw):
    """Every prompt submitted at once into a pool too small for the trace,
    so the cached-free LRU evicts."""
    clock = SimClock()
    sched = scheduler_cls(engine, (JaxServingConfig if scheduler_cls is JaxScheduler
                                   else ServingConfig)(**SERVE_KW, kv_pool_tokens=224, **kw),
                          clock=clock)
    reqs = [request_cls(prompt=p, max_new_tokens=6) for p in prompts]
    for r in reqs:
        sched.submit(r)
    for _ in range(2000):
        if not (sched.in_flight or len(sched.queue)):
            break
        sched.step()
        clock.t += 1.0
    return sched, reqs


TRACES = {"sequential": (_sequential, _shared_prefix_prompts(6, templates=2)),
          "concurrent": (_concurrent, _shared_prefix_prompts(12, template_len=40, templates=2,
                                                             seed=5))}


@pytest.fixture(scope="module")
def jax_runs(engines):
    jax_engine, _ = engines
    return {name: drive(JaxScheduler, JaxRequest, jax_engine, prompts, prefix_cache="on")
            for name, (drive, prompts) in TRACES.items()}


POOL_KEYS = ("num_blocks", "used_blocks", "cached_blocks", "prefix_hits", "prefix_misses",
             "cached_tokens_served", "prefix_evictions", "published_blocks", "total_allocs",
             "total_frees", "peak_used_blocks", "prefix_hit_rate")


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_cache_on_matches_jax(engines, jax_runs, trace):
    _, port_engine = engines
    drive, prompts = TRACES[trace]
    j_sched, j_reqs = jax_runs[trace]
    sched, reqs = drive(ContinuousBatchingScheduler, Request, port_engine, prompts,
                        prefix_cache="on")
    assert all(r.state == FINISHED for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in j_reqs]
    assert [r.cached_prefix_tokens for r in reqs] == [r.cached_prefix_tokens for r in j_reqs]
    assert sched.ticks["prefill"] == j_sched.ticks["prefill"]
    assert sched.ticks["decode"] == j_sched.ticks["decode"]
    pool, j_pool = sched.stats()["pool"], j_sched.stats()["pool"]
    assert {k: pool[k] for k in POOL_KEYS} == {k: j_pool[k] for k in POOL_KEYS}
    assert pool["used_blocks"] == 0 and pool["total_allocs"] == pool["total_frees"]
    assert sched.stats()["cached_prefix_tokens"] == j_sched.stats()["cached_prefix_tokens"] > 0
    sig, j_sig = sched.signals(), j_sched.signals()
    for key in ("prefix_cache_hit_rate", "cached_blocks", "pool_free_blocks", "finished"):
        assert sig[key] == j_sig[key], key
    assert sorted(sig["prefix_hot"]) == sorted(j_sig["prefix_hot"])
    if trace == "concurrent":
        assert pool["prefix_evictions"] > 0


def test_cache_on_gives_cache_off_tokens_with_fewer_prefill_ticks(engines, jax_runs):
    _, port_engine = engines
    drive, prompts = TRACES["sequential"]
    off, off_reqs = drive(ContinuousBatchingScheduler, Request, port_engine, prompts,
                          prefix_cache="off")
    _, j_reqs = jax_runs["sequential"]
    assert [r.output for r in off_reqs] == [r.output for r in j_reqs]
    assert all(r.cached_prefix_tokens == 0 for r in off_reqs)
    assert off.ticks["prefill"] > jax_runs["sequential"][0].ticks["prefill"]
    assert off.signals()["prefix_cache_hit_rate"] is None


@pytest.mark.parametrize("kv_quant", [True, False])
def test_kv_pool_bytes_gives_jax_block_count(engines, kv_quant):
    jax_engine, port_engine = engines
    for budget in (64 * 1024, 100_000, 1 << 20):
        kw = dict(slots=4, kv_quant=kv_quant, kv_pool_bytes=budget, prefix_cache="off")
        sched = ContinuousBatchingScheduler(port_engine, ServingConfig(**kw))
        j_sched = JaxScheduler(jax_engine, JaxServingConfig(**kw))
        assert sched._kv_bytes_per_token() == j_sched._kv_bytes_per_token()
        assert sched.pool.num_blocks == j_sched.pool.num_blocks
        st, j_st = sched.stats()["pool"], j_sched.stats()["pool"]
        assert (st["kv_block_bytes"], st["kv_blocks_per_gb"]) == \
            (j_st["kv_block_bytes"], j_st["kv_blocks_per_gb"])


def test_payload_is_stacked_by_dtype_and_restore_checks_it(engines):
    """A published block's payload is one stacked [leaves, block, ...]
    view per dtype group and role (int8 codes, their scales), not a tensor
    a leaf; a payload missing the scheduler's rows, or of another shape, is
    refused before any leaf is written."""
    _, port_engine = engines
    drive, prompts = TRACES["sequential"]
    sched, _ = drive(ContinuousBatchingScheduler, Request, port_engine, prompts[:1],
                     prefix_cache="on")
    payload = sched.pool._payload[next(iter(sched.pool._block_of))]
    assert list(payload) == ["target"]
    groups = payload["target"]
    n_layer = port_engine.module.config.n_layer
    assert sorted(str(dtype) for dtype, _ in groups) == ["torch.float32", "torch.int8"]
    for (dtype, shape), rows in groups.items():
        assert tuple(rows.shape) == (2 * n_layer, 16) + shape and rows.dtype == dtype
    before = {name: leaf.clone() for name, leaf in sched._cache.items()}
    with pytest.raises(RuntimeError, match="payload missing"):
        sched._restore_prefix(0, blocks.PrefixMatch(cached_tokens=16,
                                                    payloads=[{"drafter": groups}]))
    short = {"target": {key: rows[:, :8] for key, rows in groups.items()}}
    with pytest.raises(RuntimeError, match="the slot takes"):
        sched._restore_prefix(0, blocks.PrefixMatch(cached_tokens=16, payloads=[short]))
    assert all(torch.equal(leaf, before[name]) for name, leaf in sched._cache.items())


# ---------------------------------------------------------------------------
# kv_write="dense" is taken and gives the scatter's bits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_quant", [True, False])
def test_dense_write_gives_scatter_bits(engines, kv_quant):
    """A scheduler configured with ``kv_write="dense"`` reports it and
    leaves every cache leaf (codes and scales under int8 KV) with the
    bits of the ``"scatter"`` scheduler after the same ragged trace."""
    _, port_engine = engines
    drive, prompts = TRACES["sequential"]
    caches, outs = {}, {}
    for mode in ("scatter", "dense"):
        sched, reqs = drive(ContinuousBatchingScheduler, Request, port_engine, prompts,
                            prefix_cache="on", kv_write=mode, kv_quant=kv_quant)
        assert sched.stats()["kv_write"] == mode
        caches[mode], outs[mode] = sched._cache, [r.output for r in reqs]
    assert outs["scatter"] == outs["dense"]
    assert sorted(caches["scatter"]) == sorted(caches["dense"])
    for name, leaf in caches["scatter"].items():
        assert torch.equal(leaf, caches["dense"][name]), name


def test_dense_scheduler_matches_scatter(engines, jax_runs):
    _, port_engine = engines
    drive, prompts = TRACES["sequential"]
    _, reqs = drive(ContinuousBatchingScheduler, Request, port_engine, prompts,
                    prefix_cache="on", kv_write="dense")
    assert [r.output for r in reqs] == [r.output for r in jax_runs["sequential"][1]]


# ---------------------------------------------------------------------------
# the drain, events and the heartbeat
# ---------------------------------------------------------------------------
def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("installed", [False, True])
def test_drain_finishes_in_flight_refuses_queued_returns_143(engines, installed):
    """A preemption mid-serve finishes every request in flight in full,
    refuses the queue and returns 143; with the guard's handlers
    installed, a real SIGTERM does it."""
    import signal
    _, port_engine = engines
    sched = ContinuousBatchingScheduler(port_engine, ServingConfig(slots=2, prefill_chunk=8),
                                        clock=SimClock())
    reqs = [Request(prompt=p, max_new_tokens=12) for p in _prompts([6, 7, 8, 9, 10], seed=9)]
    guard = PreemptionGuard() if installed else PreemptionGuard(signals=[])
    orig_step, ticks = sched.step, {"n": 0}

    def stepping(admit=True):
        ticks["n"] += 1
        if ticks["n"] == 3:
            if installed:
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                guard.request("SIGTERM")
        return orig_step(admit=admit)

    sched.step = stepping
    if installed:
        guard.install()
    try:
        rc = sched.serve(reqs, guard=guard)
    finally:
        guard.uninstall()
    assert rc == DEFAULT_PREEMPT_EXIT_CODE == 143
    finished = [r for r in reqs if r.state == FINISHED]
    refused = [r for r in reqs if r.state == REFUSED]
    assert len(finished) + len(refused) == len(reqs) and refused and finished
    assert all(len(r.output) == r.max_new_tokens for r in finished)
    assert all("draining on SIGTERM" in r.refuse_reason for r in refused)
    assert sched.pool.used_blocks == 0
    assert sched.serve([Request(prompt=_prompts([5], 1)[0], max_new_tokens=2)],
                       guard=PreemptionGuard(signals=[])) == 0


def test_events_validate_and_schemas_equal_jax(engines, tmp_path, monkeypatch):
    _, port_engine = engines
    assert SERVE_EVENT_SCHEMAS == JAX_SCHEMAS
    beat = tmp_path / "heartbeat.json"
    monkeypatch.setenv(HEARTBEAT_ENV, str(beat))
    telem = RuntimeTelemetry(TelemetryConfig(enabled=True, output_path=str(tmp_path),
                                             job_name="serve"))
    telem.write_run_header({"bench": "test"})
    sched = ContinuousBatchingScheduler(port_engine, ServingConfig(slots=2, prefill_chunk=8),
                                        clock=SimClock(), telemetry=telem)
    guard = PreemptionGuard(signals=[])
    orig_step = sched.step

    def stepping(admit=True):
        if sum(sched.ticks.values()) == 4:
            guard.request("SIGTERM")
        return orig_step(admit=admit)

    sched.step = stepping
    prompts = _shared_prefix_prompts(5, seed=13)
    assert sched.serve([Request(prompt=p, max_new_tokens=4) for p in prompts], guard=guard) == 143
    ticks = sum(sched.ticks.values())
    telem.close()
    path = os.path.join(telem.run_dir, TELEMETRY_FILE)
    events = list(iter_serve_events(path))
    for rec in events:
        validate_event(rec)
    kinds = [rec["event"] for rec in events]
    assert kinds.count("serve_tick") == ticks
    assert kinds.count("serve_drain") == 1 and kinds.count("serve_request") == len(sched.finished)
    drain = next(rec for rec in events if rec["event"] == "serve_drain")
    assert drain["refused"] == sched.queue.refused > 0
    assert last_tick_signals(path)["tick"] == ticks
    bad = {k: v for k, v in last_tick_signals(path).items() if k != "cached_blocks"}
    with pytest.raises(ValueError, match="cached_blocks"):
        validate_event(bad)
    beat_payload = read_heartbeat(str(beat))
    assert beat_payload["role"] == "serving" and beat_payload["pid"] == os.getpid()
    assert {"tick", "slots_in_flight", "queue_depth", "last_tick_monotonic"} <= set(beat_payload)
