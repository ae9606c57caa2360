"""The work counts against hand-worked cases."""

from __future__ import annotations

import pytest

from portbench.work import attention, intra_loss, peaks, towers, train_step


def test_attention_counts():
    # B=2, H=3, S=4, Dh=5: q kᵀ is 2·4·4·5 = 160 a (b, h), p v the same
    assert attention.forward_flops(2, 3, 4, 5) == 6 * 320
    assert attention.backward_flops(2, 3, 4, 5) == 6 * 640
    # q, k, v, out of 2·3·4·5 = 120 bf16 elements, 240 bytes each
    assert attention.forward_bytes(2, 3, 4, 5, 2) == 4 * 240
    # + a [2, 4] fp32 mask
    assert attention.forward_bytes(2, 3, 4, 5, 2, masked=True) == 4 * 240 + 32
    # q, k, v, dout read; dq, dk, dv written
    assert attention.backward_bytes(2, 3, 4, 5, 2) == 7 * 240


def test_intra_loss_counts():
    # B=3, D=2: ṽ t̃ᵀ 2·9·2 = 36; ṽ ṽᵀ, t̃ t̃ᵀ half each, 18 + 18
    assert intra_loss.forward_flops(3, 2) == 72
    assert intra_loss.backward_flops(3, 2) == 144
    assert intra_loss.forward_bytes(3, 2) == 2 * 3 * 2 * 4
    assert intra_loss.backward_bytes(3, 2) == 4 * 3 * 2 * 4


def test_tower_counts():
    mlp = {"kind": "mlp", "input_dim": 4, "embed_dim": 2, "hidden_dim": 3,
           "num_layers": 2}
    # block 0: skip 4→2, fc1 4→3, fc2 3→2; block 1: skip 2→2, fc1 2→3, fc2 3→2
    per_row = 2 * (8 + 12 + 6 + 4 + 6 + 6)
    fwd, bwd = towers.dense_flops(mlp, 5)
    assert fwd == 5 * per_row
    # block 0's skip and fc1 read the data: no input gradient
    assert bwd == 2 * fwd - 5 * 2 * (8 + 12)
    tr = {"kind": "transformer", "input_dim": 6, "embed_dim": 4, "hidden_dim": 8,
          "num_layers": 1, "num_heads": 2, "max_seq_len": 3}
    tokens = 2 * 3
    fwd, bwd = towers.dense_flops(tr, 2)
    want = tokens * 2 * (6 * 4 + 4 * 16 + 4 * 8 * 2) + 2 * 2 * 16
    assert fwd == want
    assert bwd == 2 * want - tokens * 2 * 6 * 4
    assert towers.attention_shape(tr, 2) == (2, 2, 3, 2)
    assert towers.attention_flops(tr, 2) == (attention.forward_flops(2, 2, 3, 2),
                                             attention.backward_flops(2, 2, 3, 2))
    assert towers.attention_shape(mlp, 2) is None


def test_train_step_sums_its_parts():
    mlp = {"kind": "mlp", "input_dim": 4, "embed_dim": 2, "hidden_dim": 3,
           "num_layers": 1}
    config = {"video_tower": mlp, "text_tower": dict(mlp, input_dim=5)}
    want = (sum(towers.dense_flops(mlp, 7))
            + sum(towers.dense_flops(config["text_tower"], 7))
            + intra_loss.forward_flops(7, 2) + intra_loss.backward_flops(7, 2))
    assert train_step.flops(config, 7) == want


@pytest.mark.parametrize("flops, nbytes, bound", [(989e12, 0.0, 1.0),
                                                  (0.0, 3.35e12, 1.0),
                                                  (989e9, 6.7e12, 2.0)])
def test_least_seconds_takes_the_larger_bound(flops, nbytes, bound):
    assert peaks.least_seconds(flops, nbytes) == pytest.approx(bound)
