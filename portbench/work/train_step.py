"""The model operations of one training step of a dual-tower
configuration at batch ``B``: both towers' dense layers and attention,
forward and backward, and the intra loss's similarity products, forward
and backward.  A GradCache step's recomputed forward is not counted: the
work is the model's, not the schedule's."""

from . import intra_loss, towers


def flops(config: dict, b: int) -> float:
    total = 0.0
    for side in ("video_tower", "text_tower"):
        tower = config[side]
        total += sum(towers.dense_flops(tower, b))
        total += sum(towers.attention_flops(tower, b))
    d = config["text_tower"]["embed_dim"]
    return total + intra_loss.forward_flops(b, d) + intra_loss.backward_flops(b, d)
