"""The benchmark's own initial weights for a configuration whose text tower
is of the ``"mla_moe"`` kind (``models.mla_moe``), made on the device from
the seed in one call, under the port's state_dict names.  The video tower
(a transformer) takes ``portbench.weights``' recipes.  In the text tower:
projections ``[out, in]`` and grouped experts ``[E, in, out]`` normal
with variance ``1/in``, the two biases (``input_proj``, ``output_proj``)
normal with standard deviation 0.02, RMSNorm scales 1, and the routers'
correction biases (buffers) normal with standard deviation 0.1.  The same
dict seeds the program and the reference."""

from __future__ import annotations

import math

import torch

from . import weights

BIAS_STD = 0.02
CORRECTION_STD = 0.1


def _text(cfg: dict) -> dict[str, tuple]:
    """``{name: (shape, std)}`` of the text tower, std None for ones."""
    d, h = cfg["model_dim"], cfg["num_heads"]
    n, r, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    c, e, w = cfg["kv_lora_rank"], cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    out: dict[str, tuple] = {}

    def proj(name, i, o):
        out[f"{name}.weight"] = ((o, i), 1.0 / math.sqrt(i))

    def swiglu(name, width):
        proj(f"{name}.gate_proj", d, width)
        proj(f"{name}.up_proj", d, width)
        proj(f"{name}.down_proj", width, d)

    proj("input_proj", cfg["input_dim"], d)
    out["input_proj.bias"] = ((d,), BIAS_STD)
    for i in range(cfg["num_layers"]):
        b = f"layers.{i}."
        out[b + "input_layernorm.weight"] = ((d,), None)
        proj(b + "self_attn.q_proj", d, h * (n + r))
        proj(b + "self_attn.kv_a_proj_with_mqa", d, c + r)
        out[b + "self_attn.kv_a_layernorm.weight"] = ((c,), None)
        proj(b + "self_attn.kv_b_proj", c, h * (n + v))
        proj(b + "self_attn.o_proj", h * v, d)
        out[b + "post_attention_layernorm.weight"] = ((d,), None)
        if i < cfg["first_k_dense_replace"]:
            swiglu(b + "mlp", cfg["hidden_dim"])
            continue
        proj(b + "mlp.gate", d, e)
        out[b + "mlp.gate.e_score_correction_bias"] = ((e,), CORRECTION_STD)
        out[b + "mlp.experts.gate_up"] = ((e, d, 2 * w), 1.0 / math.sqrt(d))
        out[b + "mlp.experts.down"] = ((e, w, d), 1.0 / math.sqrt(w))
        swiglu(b + "mlp.shared_experts", cfg["n_shared_experts"] * w)
    out["norm.weight"] = ((d,), None)
    proj("output_proj", d, cfg["embed_dim"])
    out["output_proj.bias"] = ((cfg["embed_dim"],), BIAS_STD)
    return out


def buffers(config: dict) -> list[str]:
    """The leaves of the layout that are buffers, not parameters."""
    return [k for k in layout(config) if k.endswith("e_score_correction_bias")]


def layout(config: dict) -> dict[str, tuple]:
    """Every leaf's name and ``(shape, std)`` (std None: ones)."""
    out = {}
    for name, recipe in weights._tower(config["video_tower"]).items():
        key = f"video_tower.{name}"
        if recipe[0] == "ln":
            out[key] = ((recipe[1],), None)
        elif recipe[0] == "ln0":
            out[key] = ((recipe[1],), 0.0)
        elif len(recipe) == 2 and not name.endswith("pos_embed"):
            out[key] = (recipe, 1.0 / math.sqrt(recipe[1]))
        else:
            out[key] = (recipe, BIAS_STD)
    out.update({f"text_tower.{k}": v for k, v in _text(config["text_tower"]).items()})
    out["logit_scale"] = ((), None)
    return out


def make(config: dict, seed: int, device: str) -> dict[str, torch.Tensor]:
    leaves = layout(config)
    drawn = {k: shape for k, (shape, std) in leaves.items() if std}
    total = sum(math.prod(s) for s in drawn.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, (shape, std) in leaves.items():
        if std is None:
            out[name] = torch.ones(shape, device=device)
        elif std == 0.0:
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = flat[offset:offset + n].view(shape).mul_(std)
            offset += n
    return out
