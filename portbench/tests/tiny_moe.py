"""The ``moonlight_train`` cell at a size a CPU test run holds: its own
files with the widths and rows cut (text tower width 64, 4 heads, nope 16,
rope 8, values 16, kv rank 32, 8 experts with top-2, 1 shared, widths 32
and 96, 1 dense + 2 MoE layers over 12 positions; the video tower as
``tiny``'s), everything else as committed but the limits of the output
check, set from this size's own readings by the rule of ``tiny``."""

from __future__ import annotations

import copy

from portbench import harness

NAME = "moonlight_train"
# program's largest over 10 seeds / the smallest of float8, bias-out and
# unnormalised over 3 (CPU): loss 2.78e-3 / 6.4e-3, 0, 8.8e-3; grad 6.3e-3
# / 5.9e-2, 0, 0.31; change 4.6e-3 / 1.2e-2, 0, 2.4e-2; route 4.0e-3 /
# 6.6e-2, 0.24, 0.17
LIMITS = {"loss_gap": 4e-3, "grad_gap": 2e-2, "change_gap": 8e-3, "pair_faults": 0,
          "route_margin": 1.5e-2}
TEXT = dict(input_dim=24, max_seq_len=12, embed_dim=32, hidden_dim=96, num_layers=3,
            num_heads=4, model_dim=64, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
            first_k_dense_replace=1)


def cell() -> tuple[dict, dict]:
    c, cfg, _ = harness.cell_files(NAME)
    c, cfg = copy.deepcopy(c), copy.deepcopy(cfg)
    c["limits"] = dict(LIMITS)
    cfg["video_tower"].update(input_dim=16, max_seq_len=8, embed_dim=32, hidden_dim=64,
                              num_layers=2, num_heads=4)
    cfg["text_tower"].update(TEXT)
    cfg["data"]["batch_size"] = 16
    cfg["train"]["embedding_chunk"] = 8
    c["params"].update(pairs=64, reference_block=8, loss_block=8)
    return c, cfg


def run(seed: int = 2147483903, seconds: float = 0.3, trace: bool = False) -> dict:
    c, cfg = cell()
    return harness.execute(NAME, seed, seconds, trace, device="cpu", cell=c, config=cfg)
