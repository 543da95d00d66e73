"""The port's ``ServingConfig`` against the JAX one: every field the JAX
config has is a field of the port's dataclass, and each value either is
taken or raises ``NotImplementedError`` naming the later slice, never
``TypeError`` (the scheduler builds its config with ``ServingConfig(**d)``
from a JAX serving dict). ``prefix_cache=None`` is the JAX default: it
resolves to "on", which is not ported."""

import dataclasses

import pytest
from pydantic import BaseModel

from deepspeed_tpu.inference.serving.config import ServingConfig as JaxServingConfig
from deepspeed_tpu_torch.inference.serving.config import ServingConfig

JAX_FIELDS = sorted(JaxServingConfig.model_fields)


def _jax_default(name):
    value = JaxServingConfig.model_fields[name].get_default(call_default_factory=True)
    return value.model_dump() if isinstance(value, BaseModel) else value


def _taken_or_later_slice(**kwargs):
    try:
        ServingConfig(**kwargs)
    except NotImplementedError as e:
        assert "later slice" in str(e)
        return False
    return True


def test_every_jax_field_is_a_port_field():
    assert set(JAX_FIELDS) <= {f.name for f in dataclasses.fields(ServingConfig)}


@pytest.mark.parametrize("name", JAX_FIELDS)
def test_jax_default_is_taken_or_refused_as_a_later_slice(name):
    taken = _taken_or_later_slice(**{name: _jax_default(name)})
    # the JAX defaults that ask for work the port does not do are refused
    assert taken == (name not in ("prefix_cache", "tick_telemetry_every", "heartbeat_interval"))


def test_a_whole_jax_serving_dict_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="prefix caching"):
        ServingConfig(**JaxServingConfig().model_dump())
    ServingConfig(**dict(JaxServingConfig().model_dump(), prefix_cache="off",
                         tick_telemetry_every=0, heartbeat_interval=0.0))


@pytest.mark.parametrize("kwargs,taken", [
    (dict(prefix_cache="off"), True), (dict(prefix_cache=None), False),
    (dict(prefix_cache="on"), False), (dict(kv_write="scatter"), True),
    (dict(kv_write="dense"), False), (dict(kv_pool_bytes=1 << 30), False),
    (dict(tick_telemetry_every=4), False), (dict(heartbeat_interval=0.5), False),
    (dict(tick_telemetry_every=0, heartbeat_interval=0.0, kv_pool_bytes=None), True),
])
def test_unported_values_raise_naming_the_slice(kwargs, taken):
    assert _taken_or_later_slice(**kwargs) == taken


@pytest.mark.parametrize("kwargs", [dict(kv_write="ring"), dict(prefix_cache="maybe"),
                                    dict(tick_telemetry_every=-1), dict(heartbeat_interval=-1.0)])
def test_bad_values_raise_value_error_as_jax_does(kwargs):
    with pytest.raises(ValueError):
        ServingConfig(**kwargs)
    with pytest.raises(ValueError):
        JaxServingConfig(**kwargs)
