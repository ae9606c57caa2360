"""The ``moonlight_train`` cell's own pieces at a tiny CPU size
(``tiny_moe``): the weights' layout against the program's state_dict, the
work counts against a shape worked by hand, the program passing its
check, and the two planted routing faults (the correction bias left out
of the choice; the weights left unnormalised) and the float8 control
failing it, planted in the program and in the reference put in its
place."""

from __future__ import annotations

import pytest
import torch

from portbench import build, calibrate_moe, weights_moe
from portbench.reference import mla_moe as reference
from portbench.tests import tiny_moe
from portbench.work import attention, moe, peaks


def test_weights_layout_is_the_programs_state_dict():
    from crossclr_tpu_torch.models import DualEncoder

    _, cfg = tiny_moe.cell()
    model = DualEncoder(*build.towers(cfg))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(shape) for k, (shape, _) in weights_moe.layout(cfg).items()}
    assert got == want
    buffers = {k for k, _ in model.named_buffers() if k in want}
    assert set(weights_moe.buffers(cfg)) == buffers
    init = weights_moe.make(cfg, 5, "cpu")
    model.load_state_dict(init, strict=True)
    lay = weights_moe.layout(cfg)
    experts = init["text_tower.layers.1.mlp.experts.gate_up"]
    assert abs(experts.std().item() * cfg["text_tower"]["model_dim"] ** 0.5 - 1) < 0.05
    assert lay["text_tower.layers.1.mlp.gate.e_score_correction_bias"][1] == 0.1
    assert torch.all(init["text_tower.norm.weight"] == 1)


def test_work_counts_by_hand():
    tower = {"kind": "mla_moe", "input_dim": 3, "embed_dim": 2, "hidden_dim": 5,
             "num_layers": 2, "num_heads": 2, "max_seq_len": 4, "model_dim": 4,
             "kv_lora_rank": 3, "qk_nope_head_dim": 2, "qk_rope_head_dim": 2,
             "v_head_dim": 1, "moe_intermediate_size": 3, "n_routed_experts": 5,
             "num_experts_per_tok": 2, "n_shared_experts": 1, "first_k_dense_replace": 1,
             "dtype": "bfloat16"}
    b, t = 2, 8  # 2 rows of 4 tokens
    # a row of products: input_proj 3→4 (data), output_proj 4→2 over b rows;
    # a layer's MLA: q 4→8, kv_a 4→5, kv_b 3→6, o 2→4; layer 0 dense 4→5,
    # 4→5, 5→4; layer 1 router 4→5, routed (16 rows) 4→3, 4→3, 3→4, shared
    # (t rows) 4→3, 4→3, 3→4
    mla = 4 * 8 + 4 * 5 + 3 * 6 + 2 * 4
    fwd = 2 * (t * 3 * 4 + b * 4 * 2 + 2 * t * mla + t * (20 + 20 + 20)
               + t * 20 + 16 * (12 + 12 + 12) + t * (12 + 12 + 12))
    got_fwd, got_bwd = moe.text_dense_flops(tower, b)
    assert got_fwd == fwd
    assert got_bwd == 2 * fwd - 2 * t * 3 * 4  # input_proj reads the data
    # attention at qk 4, v 1: forward 2·S²·(4 + 1) a (b, h)
    assert moe.attention_flops(b, 2, 4, 4, 1) == (2 * 2 * 2 * 16 * 5, 4 * 2 * 2 * 16 * 5)
    assert moe.attention_flops(2, 3, 4, 5, 5) == (attention.forward_flops(2, 3, 4, 5),
                                                  attention.backward_flops(2, 3, 4, 5))
    assert moe.attention_bytes(2, 3, 4, 5, 5, 2) == (
        attention.forward_bytes(2, 3, 4, 5, 2), attention.backward_bytes(2, 3, 4, 5, 2))
    assert moe.tower_flops(tower, b) == fwd + got_bwd + 2 * sum(moe.attention_flops(
        b, 2, 4, 4, 1))
    # the routed products: 16 rows, 5 experts; gate 4→3, up 4→3, down 3→4
    products = moe.expert_products(tower, b)
    assert len(products) == 9
    assert products[0] == (2 * 16 * 4 * 3, (16 * 4 + 16 * 3) * 2 + 5 * 4 * 3 * 2)
    assert products[2][0] == 2 * 16 * 3 * 4
    one = sum(peaks.least_seconds(*p) for p in products[:3])
    assert moe.experts_least_seconds(tower, b) == pytest.approx(
        2 * one + sum(peaks.least_seconds(*p) for p in products[3:]))


def test_program_passes_its_check():
    result = tiny_moe.run()
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["route_margin"]["value"] <= 1e-2


def _no_bias(monkeypatch):
    from crossclr_tpu_torch.models import mla_moe

    def choose(self, m32):
        scores = torch.sigmoid(torch.matmul(m32, self.gate.weight.t()))
        if self.replay is not None:
            return scores, self.replay
        return scores, torch.topk(scores.detach(), self.cfg.num_experts_per_tok,
                                  dim=-1).indices

    monkeypatch.setattr(mla_moe.MoE, "choose", choose)


def _unnormalised(monkeypatch):
    from crossclr_tpu_torch.models import mla_moe

    def weights(self, scores, idx):
        return scores.gather(1, idx) * self.cfg.routed_scaling_factor

    monkeypatch.setattr(mla_moe.MoE, "weights", weights)


@pytest.mark.parametrize("fault", [_no_bias, _unnormalised],
                         ids=["no_bias", "unnormalised"])
def test_planted_routing_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = tiny_moe.run()
    assert result["correct"] is False, result["checks"]
    if fault is _no_bias:
        check = result["checks"]["route_margin"]
        assert check["value"] > check["limit"]


def test_control_and_faults_in_the_programs_place_fail(monkeypatch):
    captured = {}
    original = reference.run

    def capture(*a, **kw):
        captured.update(args=a, kw=kw)
        return original(*a, **kw)

    monkeypatch.setattr(reference, "run", capture)
    assert tiny_moe.run()["correct"] is True
    limits = tiny_moe.LIMITS
    found = calibrate_moe.controls(captured["args"], captured["kw"], original)
    assert set(found) == {"fp8", "no_bias", "unnormalised"}
    for name, numbers in found.items():
        assert any(numbers[k] > limits[k] for k in numbers), (name, numbers)
    assert found["no_bias"]["route_margin"] > limits["route_margin"]
