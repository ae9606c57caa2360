"""The port's towers against the Flax towers, with the Flax weights moved
across by ``utils.params.state_dict_from_flax``.

Inputs come from a seeded numpy generator and go through both packages.
Tolerances: fp32 atol 2e-5 (the same arithmetic, summed in another
order; measured at most 7.5e-7).  bf16 atol 5e-2: bf16 rounds at other
places in the two frameworks; measured on the CPU at most 2.5e-2 (the MLP
tower, outputs up to 2.5) and 1.0e-2 for the transformer towers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossclr_tpu.models import encoders as jenc
from crossclr_tpu_torch.models import encoders as tenc
from crossclr_tpu_torch.utils.params import state_dict_from_flax

FP32_ATOL = 2e-5
BF16_ATOL = 5e-2

SMALL = dict(input_dim=24, embed_dim=16, hidden_dim=32, num_layers=2,
             num_heads=4, max_seq_len=8)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(kind, dtype, attention="xla", port_attention=None, **kw):
    jdt, tdt = DTYPES[dtype]
    fields = dict(SMALL, kind=kind, **kw)
    jcfg = jenc.TowerConfig(dtype=jdt, attention=attention, **fields)
    tcfg = tenc.TowerConfig(dtype=tdt, attention=port_attention or attention,
                            **fields)
    return jcfg, tcfg


def _inputs(kind, masked, b=5, s=8, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "mlp":
        return rng.standard_normal((b, SMALL["input_dim"])).astype(np.float32), None
    x = rng.standard_normal((b, s, SMALL["input_dim"])).astype(np.float32)
    if not masked:
        return x, None
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)
    mask[-1] = 0.0  # an entry with no valid step at all
    return x, mask


def _flax_and_port(kind, jcfg, tcfg, x, mask, seed=1):
    jmod = jenc.MLPTower(jcfg) if kind == "mlp" else jenc.TransformerTower(jcfg)
    args = (jnp.asarray(x),) if kind == "mlp" else (
        jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    params = jmod.init(jax.random.PRNGKey(seed), *args)["params"]
    jout = np.asarray(jmod.apply({"params": params}, *args), np.float32)

    tmod = (tenc.MLPTower(tcfg) if kind == "mlp"
            else tenc.TransformerTower(tcfg, torch.Generator()))
    tmod.load_state_dict(state_dict_from_flax(jax.device_get(params), tmod))
    targs = [torch.from_numpy(x)] + (
        [] if kind == "mlp" else [None if mask is None else torch.from_numpy(mask)])
    with torch.inference_mode():
        tout = tmod.eval()(*targs).float().numpy()
    return jout, tout


TOWER_CASES = [
    ("mlp", "xla", False),
    ("transformer", "xla", False),
    ("transformer", "xla", True),
    ("transformer", "flash", False),
    ("transformer", "flash", True),
]


@pytest.mark.parametrize("kind,attention,masked", TOWER_CASES)
def test_fp32_towers_match_flax(kind, attention, masked):
    jcfg, tcfg = _configs(kind, "float32", attention)
    x, mask = _inputs(kind, masked)
    jout, tout = _flax_and_port(kind, jcfg, tcfg, x, mask)
    assert tout.shape == (x.shape[0], SMALL["embed_dim"])
    np.testing.assert_allclose(tout, jout, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("kind,attention,masked", TOWER_CASES)
def test_bf16_towers_stay_within_tolerance(kind, attention, masked):
    jcfg, tcfg = _configs(kind, "bfloat16", attention)
    x, mask = _inputs(kind, masked)
    jout, tout = _flax_and_port(kind, jcfg, tcfg, x, mask)
    err = float(np.max(np.abs(tout - jout)))
    assert err <= BF16_ATOL, f"max |port - flax| = {err}"


@pytest.mark.parametrize("src,dst", [("xla", "flash"), ("flash", "xla")])
def test_converter_maps_either_attention_name(src, dst):
    """A Flax tree under one attention name loads into a port tower
    built with the other; the values are the same."""
    jcfg, tcfg = _configs("transformer", "float32", src, port_attention=dst)
    x, mask = _inputs("transformer", True)
    jout, tout = _flax_and_port("transformer", jcfg, tcfg, x, mask)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=FP32_ATOL)


def _dual_params():
    jcfg, tcfg = _configs("transformer", "float32", "flash")
    jmlp, tmlp = _configs("mlp", "float32")
    jmod = jenc.DualEncoder(jcfg, jmlp)
    x, mask = _inputs("transformer", True)
    t, _ = _inputs("mlp", False)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(mask))["params"]
    params = dict(jax.device_get(params), logit_scale=np.float32(1.5))
    return params, tenc.DualEncoder(tcfg, tmlp)


def test_converter_fills_the_dual_encoder_including_logit_scale():
    params, module = _dual_params()
    sd = state_dict_from_flax(params, module)
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd)
    assert float(module.logit_scale.detach()) == 1.5
    # DenseGeneral layouts: q kernel [E, H, Dh] -> [H*Dh, E]; out [H, Dh, E]
    blk = params["video_tower"]["block_0"]["_MHA_0"]
    np.testing.assert_array_equal(
        sd["video_tower.block_0._MHA_0.query.weight"].numpy(),
        np.asarray(blk["query"]["kernel"]).reshape(16, 16).T,
    )
    np.testing.assert_array_equal(
        sd["video_tower.block_0._MHA_0.out.weight"].numpy(),
        np.asarray(blk["out"]["kernel"]).reshape(16, 16).T,
    )
    np.testing.assert_array_equal(
        sd["video_tower.block_0.LayerNorm_0.weight"].numpy(),
        np.asarray(params["video_tower"]["block_0"]["LayerNorm_0"]["scale"]),
    )


def test_converter_is_strict():
    params, module = _dual_params()
    missing = dict(params)
    del missing["logit_scale"]
    with pytest.raises(KeyError, match="logit_scale"):
        state_dict_from_flax(missing, module)

    extra = dict(params, stray=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="stray"):
        state_dict_from_flax(extra, module)

    wrong = dict(params)
    wrong["text_tower"] = dict(params["text_tower"])
    wrong["text_tower"]["norm"] = {"scale": np.ones(7, np.float32),
                                   "bias": np.zeros(16, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_flax(wrong, module)


def test_port_config_mirrors_every_tower_field():
    jnames = [f.name for f in dataclasses.fields(jenc.TowerConfig)]
    tnames = [f.name for f in dataclasses.fields(tenc.TowerConfig)]
    # every JAX field, in order; then the port's own, for its "mla_moe" kind
    assert tnames[:len(jnames)] == jnames
    assert tnames[len(jnames):] == [
        "model_dim", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim", "moe_intermediate_size", "n_routed_experts",
        "num_experts_per_tok", "n_shared_experts", "first_k_dense_replace",
        "routed_scaling_factor", "rope_theta", "rms_norm_eps"]
    # a ring tower needs a mesh (its model group), as the JAX _MHA does
    with pytest.raises(ValueError, match="attention='ring' needs a mesh"):
        tenc.TransformerTower(tenc.TowerConfig(kind="transformer",
                                               attention="ring"),
                              torch.Generator())
