"""The port's ``ServingConfig`` against the JAX one: every field the JAX
config has is a field of the port's dataclass, every JAX default and every
value the JAX config takes is taken (never ``TypeError`` or
``NotImplementedError``: the scheduler builds its config with
``ServingConfig(**d)`` from a JAX serving dict), defaults resolve as the
JAX package resolves them with no env layer set (``prefix_cache=None`` is
"on", ``kv_write=None`` is "scatter"), and the values JAX refuses with
``ValueError`` are refused so."""

import dataclasses

import pytest
import torch
from pydantic import BaseModel

from deepspeed_tpu.inference.serving.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.serving.config import (resolve_intended_kv_write,
                                                    resolve_intended_prefix_cache)
from deepspeed_tpu_torch.inference.serving.config import ServingConfig, SpeculationConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


JAX_FIELDS = sorted(JaxServingConfig.model_fields)


def _jax_default(name):
    value = JaxServingConfig.model_fields[name].get_default(call_default_factory=True)
    return value.model_dump() if isinstance(value, BaseModel) else value


def _taken_as_jax_takes(**kwargs):
    """Build both configs from ``kwargs``; True when the port takes them and
    every field (the speculation block as a dict) and resolution agrees."""
    port, jax_cfg = ServingConfig(**kwargs), JaxServingConfig(**kwargs)
    for name in JAX_FIELDS:
        want = getattr(jax_cfg, name)
        got = getattr(port, name)
        if isinstance(want, BaseModel):
            want, got = want.model_dump(), dataclasses.asdict(got)
        assert got == want, (name, got, want)
    assert port.resolved_prefix_cache == resolve_intended_prefix_cache(jax_cfg.prefix_cache)
    assert port.resolved_kv_write == resolve_intended_kv_write(jax_cfg.kv_write)
    return True


def test_every_jax_field_is_a_port_field():
    assert set(JAX_FIELDS) <= {f.name for f in dataclasses.fields(ServingConfig)}


@pytest.mark.parametrize("name", JAX_FIELDS)
def test_jax_default_is_taken_or_refused_as_a_later_slice(name):
    """Every JAX default is taken now, the port's default equals it, and
    it resolves as JAX resolves it."""
    assert _taken_as_jax_takes(**{name: _jax_default(name)})
    port_default = getattr(ServingConfig(), name)
    if isinstance(port_default, SpeculationConfig):
        port_default = dataclasses.asdict(port_default)
    assert port_default == _jax_default(name)


def test_a_whole_jax_serving_dict_raises_not_implemented():
    """A whole JAX serving dict, defaults and all, builds the port's config
    (it raised ``NotImplementedError`` until prefix caching, telemetry and
    the heartbeat were ported)."""
    cfg = ServingConfig(**JaxServingConfig().model_dump())
    assert (cfg.resolved_prefix_cache, cfg.tick_telemetry_every, cfg.heartbeat_interval) == \
        ("on", 1, 1.0)
    assert _taken_as_jax_takes(**dict(JaxServingConfig().model_dump(), prefix_cache="off",
                                      tick_telemetry_every=0, heartbeat_interval=0.0))


@pytest.mark.parametrize("kwargs,taken", [
    (dict(prefix_cache="off"), True), (dict(prefix_cache=None), True),
    (dict(prefix_cache="on"), True), (dict(kv_write="scatter"), True),
    (dict(kv_write="dense"), True), (dict(kv_pool_bytes=1 << 30), True),
    (dict(tick_telemetry_every=4), True), (dict(heartbeat_interval=0.5), True),
    (dict(tick_telemetry_every=0, heartbeat_interval=0.0, kv_pool_bytes=None), True),
    (dict(speculation={"enabled": True, "k": 3}), True),
    (dict(speculation={"enabled": True, "k": 16}, weight_dtype="int8", kv_write="dense"), True),
])
def test_unported_values_raise_naming_the_slice(kwargs, taken):
    """The values this slice ports, each refused until it, are taken as
    JAX takes them."""
    assert _taken_as_jax_takes(**kwargs) == taken


@pytest.mark.parametrize("kwargs", [dict(kv_write="ring"), dict(prefix_cache="maybe"),
                                    dict(tick_telemetry_every=-1), dict(heartbeat_interval=-1.0),
                                    dict(speculation={"enabled": True, "k": 0}),
                                    dict(speculation={"k": 17}),
                                    dict(do_sample=True, speculation={"enabled": True})])
def test_bad_values_raise_value_error_as_jax_does(kwargs):
    with pytest.raises(ValueError):
        ServingConfig(**kwargs)
    with pytest.raises(ValueError):
        JaxServingConfig(**kwargs)
