"""The work of a training step whose text tower is of the ``"mla_moe"``
kind (latent attention and routed experts, ``models.mla_moe``), counted as
the operations and not as the kernels do them.

Dense layers are ``work.towers``' ``2·n·i·o`` forward and, backward, the
weight's gradient and (unless the input is the data) the input's.  A
text tower of ``T = B·S`` tokens: ``input_proj`` (reads the data); per
layer the latent attention's projections (q ``d → H·(n + r)``, kv_a ``d →
c + r``, kv_b ``c → H·(n + v)``, o ``H·v → d``) and its attention; the
dense layers' gate, up and down; the MoE layers' router (``d → E``, over
the T tokens), the routed experts' gate, up and down over the ``T·k``
routed rows (``k`` experts a token) and the shared expert over the T
tokens; ``output_proj`` over the B pooled rows.  Norms, RoPE, the
activation, the permutation and the combine are not counted, nor the
padding of the experts' groups.

Attention of unequal widths, ``[B, H, S]`` with query/key width ``dqk``
and value width ``dv``: forward ``q kᵀ`` and ``p v``, ``2·S²·(dqk +
dv)`` per ``(b, h)``; backward ``dv = pᵀ do`` and ``dp = do vᵀ`` (``dv``
wide), ``dq = ds k`` and ``dk = dsᵀ q`` (``dqk`` wide), ``4·S²·(dqk +
dv)``.  Bytes: forward reads q, k, v and writes the output; backward reads
q, k, v and the output's gradient and writes dq, dk, dv; each at its
real width (a kernel that pads v reads and writes more).  At ``dqk = dv``
these are ``work.attention``'s counts.

The routed experts' products, for their roofline: gate and up (``T·k ×
d → w``) and down (``T·k × w → d``), forward and, backward, each one's
input gradient (``dY·Wᵀ``) and weight gradient (``Xᵀ·dY``).  Bytes: each
product's operands read and its output written once, the expert weights
``E·i·o`` whole."""

from __future__ import annotations

from . import intra_loss, peaks, towers


def _dense(n: float, i: int, o: int, data_input: bool = False) -> tuple[float, float]:
    f = 2.0 * n * i * o
    return f, f if data_input else 2.0 * f


def attention_flops(b: int, h: int, s: int, dqk: int, dv: int) -> tuple[float, float]:
    per = 2.0 * b * h * s * s * (dqk + dv)
    return per, 2.0 * per


def attention_bytes(b: int, h: int, s: int, dqk: int, dv: int, itemsize: int,
                    masked: bool = False) -> tuple[float, float]:
    rows = float(b * h * s) * itemsize
    mask = 4.0 * b * s if masked else 0.0
    return rows * (2 * dqk + 2 * dv) + mask, rows * (4 * dqk + 3 * dv) + mask


def attention_shape(tower: dict, b: int) -> tuple[int, int, int, int, int]:
    """``(B, H, S, dqk, dv)`` of one of the tower's attention calls."""
    if tower["kind"] == "mla_moe":
        return (b, tower["num_heads"], tower["max_seq_len"],
                tower["qk_nope_head_dim"] + tower["qk_rope_head_dim"], tower["v_head_dim"])
    _, h, s, dh = towers.attention_shape(tower, b)
    return b, h, s, dh, dh


def text_dense_flops(tower: dict, b: int) -> tuple[float, float]:
    """``(forward, backward)`` of the ``mla_moe`` tower's products, its
    attention apart."""
    t = b * tower["max_seq_len"]
    d, h = tower["model_dim"], tower["num_heads"]
    n, r, v = tower["qk_nope_head_dim"], tower["qk_rope_head_dim"], tower["v_head_dim"]
    c, w, e = tower["kv_lora_rank"], tower["moe_intermediate_size"], tower["n_routed_experts"]
    layers = [_dense(t, tower["input_dim"], d, True), _dense(b, d, tower["embed_dim"])]
    for i in range(tower["num_layers"]):
        layers += [_dense(t, d, h * (n + r)), _dense(t, d, c + r), _dense(t, c, h * (n + v)),
                   _dense(t, h * v, d)]
        if i < tower["first_k_dense_replace"]:
            layers += [_dense(t, d, tower["hidden_dim"])] * 2 + [_dense(t, tower["hidden_dim"], d)]
            continue
        routed = t * tower["num_experts_per_tok"]
        shared = tower["n_shared_experts"] * w
        layers += [_dense(t, d, e), _dense(routed, d, w), _dense(routed, d, w),
                   _dense(routed, w, d), _dense(t, d, shared), _dense(t, d, shared),
                   _dense(t, shared, d)]
    return sum(f for f, _ in layers), sum(g for _, g in layers)


def moe_layers(tower: dict) -> int:
    return max(tower["num_layers"] - tower["first_k_dense_replace"], 0)


def tower_flops(tower: dict, b: int) -> float:
    """A tower's operations of one step, forward and backward."""
    if tower["kind"] == "mla_moe":
        dense = sum(text_dense_flops(tower, b))
    else:
        dense = sum(towers.dense_flops(tower, b))
    if tower["kind"] == "mlp":
        return dense
    return dense + tower["num_layers"] * sum(attention_flops(*attention_shape(tower, b)))


def step_flops(config: dict, b: int) -> float:
    """The model operations of one step: both towers and the intra loss,
    forward and backward, without GradCache's recompute."""
    d = config["text_tower"]["embed_dim"]
    return (tower_flops(config["video_tower"], b) + tower_flops(config["text_tower"], b)
            + intra_loss.forward_flops(b, d) + intra_loss.backward_flops(b, d))


def expert_products(tower: dict, b: int, itemsize: int = 2) -> list[tuple[float, float]]:
    """``(operations, bytes)`` of each routed-expert product of one MoE
    layer at one step: the three forward products, then their six
    backward products."""
    rows = float(b * tower["max_seq_len"] * tower["num_experts_per_tok"])
    d, w, e = tower["model_dim"], tower["moe_intermediate_size"], tower["n_routed_experts"]
    forward, backward = [], []
    for i, o in ((d, w), (d, w), (w, d)):
        f = 2.0 * rows * i * o
        weight = float(e) * i * o * itemsize
        forward.append((f, (rows * i + rows * o) * itemsize + weight))
        backward.append((f, (rows * o + rows * i) * itemsize + weight))  # dX = dY·Wᵀ
        backward.append((f, (rows * i + rows * o) * itemsize + weight))  # dW = Xᵀ·dY
    return forward + backward


def experts_least_seconds(tower: dict, b: int, forwards: int = 2) -> float:
    """The least time of the routed experts' products of one step over
    every MoE layer, the forward products counted ``forwards`` times (the
    two-pass step runs the forward twice)."""
    products = expert_products(tower, b)
    fwd = sum(peaks.least_seconds(f, n) for f, n in products[:3])
    bwd = sum(peaks.least_seconds(f, n) for f, n in products[3:])
    return moe_layers(tower) * (forwards * fwd + bwd)


def attention_least_seconds(config: dict, b: int, forwards: int = 2) -> float:
    """The least time of both towers' attention calls of one step, the
    forward counted ``forwards`` times."""
    least = 0.0
    for side in ("video_tower", "text_tower"):
        tower = config[side]
        if tower["kind"] == "mlp":
            continue
        shape = attention_shape(tower, b)
        size = 2 if tower["dtype"] == "bfloat16" else 4
        (ff, bf), (fb, bb) = attention_flops(*shape), attention_bytes(*shape, size)
        least += tower["num_layers"] * (forwards * peaks.least_seconds(ff, fb)
                                        + peaks.least_seconds(bf, bb))
    return least
