"""The benchmark's own initial weights, made on the device from the seed
in a few large calls, under the port's state_dict names: dense weights
``[out, in]`` normal with variance ``1/in``, biases and ``pos_embed``
normal with standard deviation 0.02, LayerNorm scales 1 and shifts 0,
``logit_scale`` 1.  The same dict seeds the program and the reference."""

from __future__ import annotations

import math

import torch


def _tower(cfg: dict) -> dict[str, tuple]:
    e, h = cfg["embed_dim"], cfg["hidden_dim"]
    out: dict[str, tuple] = {}

    def dense(name, i, o):
        out[f"{name}.weight"] = (o, i)
        out[f"{name}.bias"] = (o,)

    def norm(name, d):
        out[f"{name}.weight"] = ("ln", d)
        out[f"{name}.bias"] = ("ln0", d)

    if cfg["kind"] == "transformer":
        dense("input_proj", cfg["input_dim"], e)
        out["pos_embed"] = (cfg["max_seq_len"], e)
        for layer in range(cfg["num_layers"]):
            b = f"block_{layer}."
            norm(b + "LayerNorm_0", e)
            for w in ("query", "key", "value", "out"):
                dense(f"{b}_MHA_0.{w}", e, e)
            norm(b + "LayerNorm_1", e)
            dense(b + "Dense_0", e, h)
            dense(b + "Dense_1", h, e)
        norm("final_norm", e)
        dense("output_proj", e, e)
    else:
        i = cfg["input_dim"]
        for block in range(max(cfg["num_layers"], 1)):
            sfx = "" if block == 0 else f"_{block}"
            dense("skip" + sfx, i, e)
            dense("fc1" + sfx, i, h)
            dense("fc2" + sfx, h, e)
            i = e
        norm("norm", e)
    return out


def layout(config: dict) -> dict[str, tuple]:
    """Every leaf's name and its recipe: a shape, or ``("ln", d)`` /
    ``("ln0", d)`` for LayerNorm scales and shifts."""
    out = {}
    for side in ("video", "text"):
        out.update({f"{side}_tower.{k}": v
                    for k, v in _tower(config[f"{side}_tower"]).items()})
    out["logit_scale"] = ()
    return out


def make(config: dict, seed: int, device: str) -> dict[str, torch.Tensor]:
    leaves = layout(config)
    random = {k: s for k, s in leaves.items() if s and s[0] not in ("ln", "ln0")}
    total = sum(math.prod(s) for s in random.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, recipe in leaves.items():
        if not recipe:
            out[name] = torch.ones((), device=device)
        elif recipe[0] == "ln":
            out[name] = torch.ones(recipe[1], device=device)
        elif recipe[0] == "ln0":
            out[name] = torch.zeros(recipe[1], device=device)
        else:
            n = math.prod(recipe)
            piece = flat[offset:offset + n].view(recipe)
            offset += n
            scale = (1.0 / math.sqrt(recipe[1]) if len(recipe) == 2
                     and not name.endswith("pos_embed") else 0.02)
            out[name] = piece.mul_(scale)
    return out
