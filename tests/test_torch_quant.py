"""The port's int8w quantizer (``cst_captioning_torch/ops/quant.py``)
against the JAX package's ``ops/quant.py`` on the same numpy weights, and
the weight bridge's carriage of a quantized tree.

Tolerances: codes, scales and scale hashes bit-exact for both
calibrations (a one-ulp difference in a scale changes codes);
``quant_matmul`` within 1e-6 relative to the largest output (float32
sums in two libraries' orders), ``dequant_rows`` bit-exact (one multiply
and one rounding); the byte accounting exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models.captioner import CaptionModel as JaxModel
from cst_captioning_tpu.ops import quant as jq
from cst_captioning_torch.models.captioner import CaptionModel
from cst_captioning_torch.models.weights import (
    load_params,
    params_to_state_dict,
    state_dict_to_params,
)
from cst_captioning_torch.ops import quant as tq

MATMUL_RTOL = 1e-6
CALS = ("absmax", "percentile")
# (shape, axis) pairs: the model's leaves at small and full widths, odd
# channel lengths whose percentile position lands between two elements.
SHAPES = [((40, 16), 0), ((16, 40), 1), ((48, 64), 1), ((1000, 7), 0),
          ((7, 300), 1), ((1536, 2048), 1), ((512, 10496), 1),
          ((10496, 512), 0)]


def _w(shape, seed, zero_channel=None, axis=1):
    rng = np.random.RandomState(seed)
    w = (rng.randn(*shape) * 0.1).astype(np.float32)
    if zero_channel is not None:
        idx = [slice(None)] * 2
        idx[axis] = zero_channel
        w[tuple(idx)] = 0.0
    return w


@pytest.mark.parametrize("cal", CALS)
@pytest.mark.parametrize("shape,axis", SHAPES)
def test_quantize_per_channel_bit_exact(shape, axis, cal):
    w = _w(shape, sum(shape), zero_channel=1, axis=axis)
    jqv, js = jq.quantize_per_channel(jnp.asarray(w), axis, cal)
    tqv, ts = tq.quantize_per_channel(torch.from_numpy(w), axis, cal)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    assert float(ts[1]) == 1.0        # the all-zero channel
    # numpy input goes through the same path
    np.testing.assert_array_equal(
        tq.quantize_per_channel(w, axis, cal)[1].numpy(), ts.numpy())


def test_round_half_to_even_matches():
    # values at exact .5 multiples of the scale: 127 * k / 2 / 127.
    w = np.array([[1.0, 0.5 / 127, 1.5 / 127, 2.5 / 127, -0.5 / 127,
                   -2.5 / 127, 126.5 / 127]], np.float32).T
    jqv, _ = jq.quantize_per_channel(jnp.asarray(w), 1)
    tqv, _ = tq.quantize_per_channel(torch.from_numpy(w), 1)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))


def test_unknown_calibration_raises():
    with pytest.raises(ValueError, match="calibration"):
        tq.quantize_per_channel(np.ones((2, 2), np.float32), 0, "minmax")


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
@pytest.mark.parametrize("cal", CALS)
def test_scale_hashes_equal_on_a_model_tree(fusion, cal):
    V, E, H, D, F = 57, 24, 32, 40, 5
    jm = JaxModel(vocab_size=V, rnn_size=H, embed_size=E,
                  modalities=("resnet",), feature_dims=(D,),
                  compute_dtype="float32", fusion=fusion,
                  att_hidden_size=24)
    feats = {"resnet": jnp.zeros((2, F, D))}
    masks = {"resnet": jnp.ones((2, F))}
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(3), feats, masks, jnp.zeros((2, 3), jnp.int32)))
    jqp = jq.quantize_params(params, cal)
    tqp = tq.quantize_params(params_to_state_dict(params), cal)
    assert tq.scale_hashes(tqp) == jq.scale_hashes(jqp)
    assert len(tq.scale_hashes(tqp)) == (5 if fusion == "attention" else 3)
    for name, leaf in jqp["params"].items():
        np.testing.assert_array_equal(np.asarray(tqp[name]), np.asarray(leaf))
    # the JAX layout goes through the port's tree ops too
    assert tq.scale_hashes(tq.quantize_params(params, cal)) == \
        jq.scale_hashes(jqp)


def test_quant_axis_rules_match():
    for name in ("word_embed", "logit_w", "lstm0_w", "lstm3_w", "att_wf",
                 "att_wh", "att_v", "att_b", "lstm0_b", "proj_resnet_w",
                 "logit_b", "word_embed_scale"):
        assert tq.quant_axis(name) == jq.quant_axis(name), name


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_quant_matmul_and_dequant_rows(xdt):
    rng = np.random.RandomState(1)
    w = (rng.randn(48, 96) * 0.2).astype(np.float32)
    x = (rng.randn(5, 48)).astype(np.float32)
    jqv, js = jq.quantize_per_channel(jnp.asarray(w), 1)
    j = np.asarray(jq.quant_matmul(jnp.asarray(x).astype(xdt), jqv, js))
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    t = tq.quant_matmul(tx, torch.from_numpy(np.asarray(jqv)),
                        torch.from_numpy(np.asarray(js))).numpy()
    assert t.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=MATMUL_RTOL * np.abs(j).max())
    e = (rng.randn(30, 16) * 0.1).astype(np.float32)
    eq, es = jq.quantize_per_channel(jnp.asarray(e), 0)
    ids = np.array([[3, 0, 29], [7, 7, 1]], np.int32)
    jr = np.asarray(jq.dequant_rows(eq, es, jnp.asarray(ids), xdt)
                    .astype(jnp.float32))
    tr = tq.dequant_rows(torch.from_numpy(np.asarray(eq)),
                         torch.from_numpy(np.asarray(es)),
                         torch.from_numpy(ids).long(), getattr(torch, xdt))
    np.testing.assert_array_equal(tr.float().numpy(), jr)
    np.testing.assert_array_equal(
        tq.dequantize(torch.from_numpy(np.asarray(eq)),
                      torch.from_numpy(np.asarray(es)), 0).numpy(),
        np.asarray(jq.dequantize(eq, es, 0)))


def test_is_quantized_and_leaf_bytes():
    w = {"word_embed": np.zeros((6, 4), np.float32),
         "logit_w": np.zeros((4, 6), np.float32),
         "logit_b": np.zeros((6,), np.float32)}
    assert tq.is_quantized(w) is False
    assert jq.is_quantized(w) is False
    qp = tq.quantize_params(w)
    assert tq.is_quantized(qp) is True
    assert tq.is_quantized({"params": qp}) is True
    assert tq.is_quantized({"logit_b": np.zeros(3)}) is False
    assert jq.is_quantized(jq.quantize_params(w)) is True
    for shape, axis in SHAPES:
        assert tq.quantized_leaf_bytes(shape, axis) == \
            jq.quantized_leaf_bytes(shape, axis)
        n, s = tq.quantized_leaf_bytes(shape, axis)
        assert n == int(np.prod(shape)) and s == shape[axis] * 4


@pytest.mark.parametrize("fusion", ["meanpool", "attention"])
def test_weight_bridge_round_trips_a_quantized_tree(fusion):
    """A JAX int8w tree crosses into a weight_quant model code for code,
    and back: int8 stays int8, each scale crosses name for name."""
    V, E, H, D, F = 50, 16, 16, 24, 4
    jm = JaxModel(vocab_size=V, rnn_size=H, embed_size=E,
                  modalities=("resnet",), feature_dims=(D,),
                  compute_dtype="float32", fusion=fusion,
                  att_hidden_size=16)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), {"resnet": jnp.zeros((2, F, D))},
        {"resnet": jnp.ones((2, F))}, jnp.zeros((2, 3), jnp.int32)))
    jqp = jax.tree.map(np.asarray, jq.quantize_params(params, "percentile"))
    model = CaptionModel(vocab_size=V, rnn_size=H, embed_size=E,
                         feature_dims=(D,), compute_dtype="float32",
                         fusion=fusion, att_hidden_size=16,
                         weight_quant=True, device="cpu")
    load_params(model, jqp)
    sd = params_to_state_dict(jqp)
    assert sd["word_embed"].dtype == torch.int8
    assert sd["word_embed_scale"].dtype == torch.float32
    back = state_dict_to_params(model.state_dict())["params"]
    assert set(back) == set(jqp["params"])
    for name, leaf in jqp["params"].items():
        assert back[name].dtype == leaf.dtype, name
        np.testing.assert_array_equal(back[name], leaf)
    # a float leaf for an int8 parameter is refused, not truncated
    with pytest.raises(ValueError, match="int8"):
        load_params(model, dict(params["params"], **{
            k: v for k, v in jqp["params"].items() if k.endswith("_scale")}))
