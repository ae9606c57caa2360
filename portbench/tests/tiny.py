"""Each cell at a size a CPU test run holds: the cell's own files with its
widths and rows cut, everything else as committed but the limits of the
output check.  Fewer and narrower rows average less rounding away, so
the bf16 program reads higher against the float32 reference here than at
the cells' sizes on the card; ``LIMITS`` are set from this size's own
readings by the same rule (CPU, ten seeds of the program, three of the
float8 control and of the planted faults), where the cells' files hold
the limits set on the card."""

from __future__ import annotations

import copy

from portbench import harness


# (program's largest over 10 seeds; control's / fault's smallest over 3)
LIMITS = {
    # loss 1.45e-3 / 7.9e-3; grad 1.13e-2 / 2.94e-2; change 1.83e-2 / half 0.202
    "lsmdc_train": {"loss_gap": 4e-3, "grad_gap": 2e-2, "change_gap": 4e-2,
                    "pair_faults": 0},
    # loss 2.05e-3 / 8.0e-3; grad 6.3e-3 / 2.73e-2; change 1.38e-2 / half 9.8e-2
    "podslice_train": {"loss_gap": 4e-3, "grad_gap": 1.5e-2, "change_gap": 4e-2,
                       "pair_faults": 0},
}


def cell(name: str) -> tuple[dict, dict]:
    c, cfg, _ = harness.cell_files(name)
    c, cfg = copy.deepcopy(c), copy.deepcopy(cfg)
    c["limits"] = dict(LIMITS[name])
    if cfg["video_tower"]["kind"] == "transformer":
        for side, (width, seq) in (("video_tower", (16, 8)), ("text_tower", (24, 12))):
            cfg[side].update(input_dim=width, max_seq_len=seq, embed_dim=32,
                             hidden_dim=64, num_layers=2, num_heads=4)
    else:
        for side, width in (("video_tower", 24), ("text_tower", 16)):
            cfg[side].update(input_dim=width, embed_dim=16, hidden_dim=32)
    if cfg["video_tower"]["kind"] == "transformer":
        cfg["data"]["batch_size"] = 16
        c["params"].update(pairs=64, reference_block=8, loss_block=8)
    else:
        cfg["data"]["batch_size"] = 32
        cfg["train"]["embedding_chunk"] = 8
        c["params"].update(pairs=256, reference_block=16, loss_block=8)
    return c, cfg


def run(name: str, seed: int = 2147483903, seconds: float = 0.3,
        trace: bool = False) -> dict:
    c, cfg = cell(name)
    return harness.execute(name, seed, seconds, trace, device="cpu", cell=c,
                           config=cfg)


CELLS = ("lsmdc_train", "podslice_train")
