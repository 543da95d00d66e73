"""The port's encoder layer, tiled linear layers and spatial ops against the
JAX package's.

``DeepSpeedTransformerLayer`` (64 wide, 4 heads, fp32) from JAX's weights:
its output and the gradients of one seeded cotangent with respect to the
input and every weight within 1e-5 of the largest, pre-LN and post-LN, with
a ``[B, L]`` padding mask, under remat (the memory switches' checkpoint
region), with ``return_tuple``, and on the ``"flash"`` backend (plain
versions here) without a mask; ``adjust_init_range``'s output-projection
scale in both packages' draws. ``TiledLinear`` and
``TiledLinearReturnBias`` at (in, out) splits (1, 1), (2, 3) and (3, 2):
outputs and gradients within 1e-6 of the largest, and the near-equal split
rule's error. The spatial bias-add ops bit-equal to JAX's in both layouts,
with JAX's errors.
"""

import flax.linen as fnn
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import spatial as jax_spatial
from deepspeed_tpu.ops.transformer import (DeepSpeedTransformerConfig as JaxLayerConfig,
                                           DeepSpeedTransformerLayer as JaxLayer)
from deepspeed_tpu.runtime.zero.tiling import (TiledLinear as JaxTiled,
                                               TiledLinearReturnBias as JaxTiledBias)
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.models.common import flatten_tree
from deepspeed_tpu_torch.ops import spatial
from deepspeed_tpu_torch.ops.transformer import DeepSpeedTransformerConfig, DeepSpeedTransformerLayer
from deepspeed_tpu_torch.runtime.zero import TiledLinear, TiledLinearReturnBias
from deepspeed_tpu_torch.runtime.zero.tiling import _split_sizes


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, L, E = 2, 16, 64
LAYER = dict(hidden_size=E, heads=4, num_hidden_layers=2)
#: name -> (config overrides, with a [B, L] padding mask)
VARIANTS = {"pre-ln": ({}, False), "post-ln-mask": (dict(pre_layer_norm=False), True),
            "remat-mask": (dict(gelu_checkpoint=True), True)}


def _layer_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, L, E)).astype(np.float32)
    mask = (np.arange(L)[None] < np.asarray([L, 9])[:, None]).astype(np.int32)
    cot = rng.standard_normal((B, L, E)).astype(np.float32)
    return x, mask, cot


def _max_err(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


@pytest.fixture(scope="module")
def jax_layers():
    """Per variant: JAX's weights, output and gradients (input and weights)."""
    x, mask, cot = _layer_inputs()
    out = {}
    for name, (over, masked) in VARIANTS.items():
        module = JaxLayer(JaxLayerConfig(**LAYER, **over))
        m = jnp.asarray(mask) if masked else None
        params = fnn.meta.unbox(jax.jit(module.init)(jax.random.PRNGKey(1), jnp.asarray(x),
                                                     m)["params"])

        def f(p, xx):
            y = module.apply({"params": p}, xx, m)
            return jnp.sum(y * cot), y

        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(params, x)
        out[name] = dict(params=jax.device_get(params), y=np.asarray(y), gx=np.asarray(gx),
                         grads={k: np.asarray(v) for k, v in flatten_tree(gp, "/").items()})
    return out


def _port_layer(tree, **over):
    cfg = DeepSpeedTransformerConfig(**LAYER, **over)
    layer = DeepSpeedTransformerLayer(cfg, device="cpu")
    layer.load_state_dict(params_from_jax(tree, cfg))
    return layer


@pytest.mark.parametrize("variant,backend,tuple_out", [
    ("pre-ln", "xla", False), ("pre-ln", "flash", False), ("pre-ln", "xla", True),
    ("post-ln-mask", "xla", False), ("remat-mask", "xla", False)])
def test_layer_matches_jax(jax_layers, variant, backend, tuple_out):
    ref = jax_layers[variant]
    over, masked = VARIANTS[variant]
    layer = _port_layer(ref["params"], attention_backend=backend, return_tuple=tuple_out, **over)
    assert layer.config.remat == (variant == "remat-mask")
    x, mask, cot = _layer_inputs()
    xt = torch.from_numpy(x).requires_grad_()
    y = layer(xt, torch.from_numpy(mask) if masked else None)
    if tuple_out:
        assert isinstance(y, tuple) and len(y) == 1
        y = y[0]
    (y * torch.from_numpy(cot)).sum().backward()
    assert _max_err(y.detach(), ref["y"]) <= 1e-5 * np.abs(ref["y"]).max()
    scale = max(np.abs(g).max() for g in list(ref["grads"].values()) + [ref["gx"]])
    assert _max_err(xt.grad, ref["gx"]) <= 1e-5 * scale
    grads = params_to_jax({n: p.grad for n, p in layer.named_parameters()})
    assert set(grads) == set(ref["grads"])
    for path, want in ref["grads"].items():
        assert _max_err(grads[path], want) <= 1e-5 * scale, path


def test_adjust_init_range_scales_the_output_projections():
    """Both packages draw ``attn_out`` and ``output`` at ``0.02 /
    sqrt(2 n_layers)`` and the other kernels at 0.02 (sample standard
    deviations within 5%)."""
    cfg = dict(hidden_size=64, heads=4, num_hidden_layers=8)
    out_scale = 0.02 / np.sqrt(16.0)
    port = params_to_jax(DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**cfg), device="cpu",
                                                   generator=torch.Generator().manual_seed(2))
                         .state_dict())
    module = JaxLayer(JaxLayerConfig(**cfg))
    tree = flatten_tree(jax.device_get(fnn.meta.unbox(jax.jit(module.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 4, 64)))["params"])), "/")
    for flat in (port, tree):
        for name, want in (("attn_qkv", 0.02), ("attn_out", out_scale), ("inter", 0.02),
                           ("output", out_scale)):
            std = float(np.std(np.asarray(flat[f"layer/{name}/kernel"])))
            assert abs(std / want - 1.0) < 0.05, (name, std, want)
    plain = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**cfg, adjust_init_range=False),
                                      device="cpu")
    assert abs(float(plain.layer.attn_out.kernel.detach().std()) / 0.02 - 1.0) < 0.05


TILE_IN, TILE_OUT = 24, 30


@pytest.mark.parametrize("splits", [(1, 1), (2, 3), (3, 2)])
def test_tiled_linear_matches_jax(splits):
    in_splits, out_splits = splits
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, TILE_IN)).astype(np.float32)
    cot = rng.standard_normal((3, 5, TILE_OUT)).astype(np.float32)
    module = JaxTiled(TILE_IN, TILE_OUT, in_splits=in_splits, out_splits=out_splits)
    params = fnn.meta.unbox(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params = jax.tree.map(lambda p: p + 0.1, params)  # nonzero biases

    def f(p, xx):
        y = module.apply({"params": p}, xx)
        return jnp.sum(y * cot), y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(params, x)
    port = TiledLinear(TILE_IN, TILE_OUT, in_splits=in_splits, out_splits=out_splits, device="cpu")
    port.load_state_dict(params_from_jax(jax.device_get(params), port))
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    assert _max_err(y.detach(), want) <= 1e-6 * np.abs(want).max()
    assert _max_err(xt.grad, gx) <= 1e-6 * np.abs(gx).max()
    for path, g in flatten_tree(gp, "/").items():
        assert _max_err(getattr(port, path).grad, g) <= 1e-6 * np.abs(g).max(), path
    bias_module = JaxTiledBias(TILE_IN, TILE_OUT, in_splits=in_splits, out_splits=out_splits)
    want_y, want_b = bias_module.apply({"params": params}, x)
    bias_port = TiledLinearReturnBias(TILE_IN, TILE_OUT, in_splits=in_splits, out_splits=out_splits,
                                      device="cpu")
    bias_port.load_state_dict(port.state_dict())
    got_y, got_b = bias_port(torch.from_numpy(x))
    assert _max_err(got_y.detach(), want_y) <= 1e-6 * np.abs(want_y).max()
    assert np.array_equal(got_b.detach().numpy(), np.asarray(want_b))


def test_tiled_linear_split_rule_and_errors():
    assert _split_sizes(10, 3) == [4, 3, 3]
    with pytest.raises(ValueError, match="cannot split dim 2 into 3 tiles"):
        TiledLinear(2, 8, in_splits=3, device="cpu")
    with pytest.raises(ValueError, match="input feature dim 5 != 6"):
        TiledLinear(6, 4, device="cpu")(torch.zeros(2, 5))


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_spatial_ops_bit_equal_jax(layout):
    rng = np.random.default_rng(5)
    shape = (2, 4, 6, 8) if layout == "nhwc" else (2, 8, 4, 6)
    a, o = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    b, ob = (rng.standard_normal(8).astype(np.float32) for _ in range(2))
    t = torch.from_numpy
    pairs = [(spatial.nhwc_bias_add(t(a), t(b), layout), jax_spatial.nhwc_bias_add(a, b, layout)),
             (spatial.nhwc_bias_add_add(t(a), t(b), t(o), layout),
              jax_spatial.nhwc_bias_add_add(a, b, o, layout)),
             (spatial.nhwc_bias_add_bias_add(t(a), t(b), t(o), t(ob), layout),
              jax_spatial.nhwc_bias_add_bias_add(a, b, o, ob, layout))]
    for got, want in pairs:
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_spatial_ops_raise_as_jax():
    a, b = np.zeros((1, 2, 2, 3), np.float32), np.zeros(4, np.float32)
    for fn in (lambda m, x, y, layout: m.nhwc_bias_add(x, y, layout),):
        for layout, match in (("nhwc", "bias 4 != channel dim 3"), ("nchw", "bias 4 != channel dim 2"),
                              ("nwhc", "layout must be 'nhwc' or 'nchw'")):
            for mod, x, y in ((spatial, torch.from_numpy(a), torch.from_numpy(b)), (jax_spatial, a, b)):
                with pytest.raises(ValueError, match=match):
                    fn(mod, x, y, layout)


def test_layer_dropout_draws_once_per_call_and_recomputes_the_same():
    """With the dropout ratios and a generator the layer draws one seed a
    call, so its checkpointed form recomputes the same masks: output and
    gradients bit-equal with and without remat."""
    x, mask, cot = _layer_inputs()
    runs = []
    for remat in (False, True):
        cfg = DeepSpeedTransformerConfig(**LAYER, attn_dropout_ratio=0.1, hidden_dropout_ratio=0.1,
                                         gelu_checkpoint=remat)
        layer = DeepSpeedTransformerLayer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        y = layer(torch.from_numpy(x), torch.from_numpy(mask), deterministic=False,
                  generator=torch.Generator().manual_seed(3))
        (y * torch.from_numpy(cot)).sum().backward()
        runs.append([y.detach()] + [p.grad for p in layer.parameters()])
        with torch.no_grad():
            assert not torch.equal(layer(torch.from_numpy(x), torch.from_numpy(mask)), y)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
