"""The matrix products of the towers (``models.encoders``' layers), per
step of ``B`` rows, forward and backward.

A dense layer of ``n`` rows, ``i`` inputs and ``o`` outputs is ``2·n·i·o``
forward; backward is its weight's gradient (``2·n·i·o``) and, unless its
input is the data, its input's gradient (``2·n·i·o`` again).  A
transformer tower of ``S`` tokens a row: ``input_proj`` (its input is the
data), per block the q, k, v and out projections (``E × E``) and the MLP
pair (``E × hidden``, ``hidden × E``) over ``B·S`` tokens, and
``output_proj`` (``E × E``) over the ``B`` pooled rows; attention's own
products are ``work.attention``'s.  An MLP tower: per block ``skip``
(``in × E``), ``fc1`` (``in × hidden``) and ``fc2`` (``hidden × E``),
block 0's ``skip`` and ``fc1`` reading the data.  LayerNorms, GELUs,
pooling and the adds are not counted."""

from . import attention


def _dense(n: int, i: int, o: int, data_input: bool) -> tuple[float, float]:
    f = 2.0 * n * i * o
    return f, f if data_input else 2.0 * f


def dense_flops(tower: dict, b: int) -> tuple[float, float]:
    """``(forward, backward)`` operations of the tower's dense layers."""
    e, h = tower["embed_dim"], tower["hidden_dim"]
    layers = []
    if tower["kind"] == "transformer":
        n = b * tower["max_seq_len"]
        layers.append(_dense(n, tower["input_dim"], e, True))
        for _ in range(tower.get("num_layers", 2)):
            layers += [_dense(n, e, e, False)] * 4
            layers += [_dense(n, e, h, False), _dense(n, h, e, False)]
        layers.append(_dense(b, e, e, False))
    else:
        i = tower["input_dim"]
        for block in range(max(tower.get("num_layers", 2), 1)):
            first = block == 0
            layers += [_dense(b, i, e, first), _dense(b, i, h, first),
                       _dense(b, h, e, False)]
            i = e
    return sum(f for f, _ in layers), sum(g for _, g in layers)


def attention_shape(tower: dict, b: int) -> tuple[int, int, int, int] | None:
    """``(B, H, S, Dh)`` of each of a transformer tower's attention calls
    (one a block), None for an MLP tower."""
    if tower["kind"] != "transformer":
        return None
    h = tower["num_heads"]
    return b, h, tower["max_seq_len"], tower["embed_dim"] // h


def attention_flops(tower: dict, b: int) -> tuple[float, float]:
    shape = attention_shape(tower, b)
    if shape is None:
        return 0.0, 0.0
    n = tower.get("num_layers", 2)
    return (n * attention.forward_flops(*shape),
            n * attention.backward_flops(*shape))
