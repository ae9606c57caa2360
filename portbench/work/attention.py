"""Attention ``softmax(q kᵀ / sqrt(Dh)) v`` over ``[B, H, S, Dh]``, key
padding masked, counted as the operation and not as a kernel does it.

Forward: ``q kᵀ`` and ``p v``, ``2·S·S·Dh`` operations each per
``(b, h)``: ``4·B·H·S²·Dh``.  Backward, with no recompute counted:
``dv = pᵀ do``, ``dp = do vᵀ``, ``dq = ds k``, ``dk = dsᵀ q``:
``8·B·H·S²·Dh``.  Bytes: each input read once and each output written
once, in the element size of the operands: forward reads q, k, v (and a
``[B, S]`` fp32 mask) and writes the output; backward reads q, k, v and
the output's gradient (and the mask) and writes dq, dk, dv."""


def forward_flops(b: int, h: int, s: int, dh: int) -> float:
    return 4.0 * b * h * s * s * dh


def backward_flops(b: int, h: int, s: int, dh: int) -> float:
    return 8.0 * b * h * s * s * dh


def forward_bytes(b: int, h: int, s: int, dh: int, itemsize: int,
                  masked: bool = False) -> float:
    return 4.0 * b * h * s * dh * itemsize + (4.0 * b * s if masked else 0.0)


def backward_bytes(b: int, h: int, s: int, dh: int, itemsize: int,
                   masked: bool = False) -> float:
    return 7.0 * b * h * s * dh * itemsize + (4.0 * b * s if masked else 0.0)
