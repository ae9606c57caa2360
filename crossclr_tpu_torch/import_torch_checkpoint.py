"""Import a PyTorch dual-tower checkpoint into a port checkpoint:
``python -m crossclr_tpu_torch.import_torch_checkpoint``.

Counterpart of ``scripts/import_torch_checkpoint.py``, with the same
flags: take the torch state_dicts of a user's video and text towers (and
optionally the reference criterion's ``logit_scale``), convert them onto
the port's towers (``utils.torch_import``), and write a step-0 checkpoint
that ``crossclr_tpu_torch.eval``, ``crossclr_tpu_torch.serve
--checkpoint-dir`` and the train CLI's resume load directly.

The torch file may be:
* a flat ``state_dict`` whose keys carry tower prefixes
  (``--video-prefix`` / ``--text-prefix``, stripped before matching), or
* a dict of dicts (e.g. ``{"video": sd, "text": sd, "criterion": sd}``)
  — select with ``--video-key`` / ``--text-key`` / ``--criterion-key``.

Usage:
  python -m crossclr_tpu_torch.import_torch_checkpoint --config cfg.json \\
      --torch-ckpt towers.pt --output ckpt_dir \\
      [--video-prefix video_tower.] [--text-prefix text_tower.] \\
      [--criterion-prefix criterion.] [--no-strict]
"""

from __future__ import annotations

import argparse


def _sub_dict(sd: dict, prefix: str) -> dict:
    """Entries under ``prefix``, with the prefix stripped."""
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not out:
        raise SystemExit(
            f"no keys under prefix {prefix!r} (state_dict has "
            f"{sorted(sd)[:20]})"
        )
    return out


def main(argv=None) -> int:
    import torch

    from .training import CheckpointManager, Trainer
    from .utils.config import ExperimentConfig, apply_overrides, load_config
    from .utils.torch_import import dual_encoder_params_from_torch

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, help="ExperimentConfig JSON")
    ap.add_argument("--torch-ckpt", required=True, help=".pt file (torch.save)")
    ap.add_argument("--output", required=True, help="port checkpoint directory")
    ap.add_argument("--video-prefix", default="video_tower.")
    ap.add_argument("--text-prefix", default="text_tower.")
    ap.add_argument("--criterion-prefix", default=None,
                    help="prefix of the reference criterion's state "
                    "(imports logit_scale); omit to keep the initial value")
    ap.add_argument("--video-key", default=None,
                    help="nested-dict key holding the video state_dict")
    ap.add_argument("--text-key", default=None)
    ap.add_argument("--criterion-key", default=None)
    ap.add_argument("--no-strict", action="store_true",
                    help="ignore torch entries that match no parameter")
    ap.add_argument("overrides", nargs="*", help="section.key=value overrides")
    args = ap.parse_args(argv)

    cfg = load_config(args.config) if args.config else ExperimentConfig()
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    # the user's own checkpoint, which may pickle a whole module
    blob = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    if hasattr(blob, "state_dict"):
        blob = blob.state_dict()
    if args.video_key or args.text_key:
        if not (args.video_key and args.text_key):
            raise SystemExit("--video-key and --text-key go together")
        video_sd, text_sd = blob[args.video_key], blob[args.text_key]
    else:
        video_sd = _sub_dict(blob, args.video_prefix)
        text_sd = _sub_dict(blob, args.text_prefix)
    # the criterion selector is independent of the tower mode: a flat
    # prefixed checkpoint may still nest the criterion under a key
    if args.criterion_key and args.criterion_prefix:
        raise SystemExit(
            "pass --criterion-key OR --criterion-prefix, not both"
        )
    if args.criterion_key:
        if args.criterion_key not in blob:
            raise SystemExit(
                f"--criterion-key {args.criterion_key!r} not in the "
                f"checkpoint (top-level keys: {sorted(blob)[:20]})"
            )
        crit_sd = blob[args.criterion_key]
    elif args.criterion_prefix:
        crit_sd = _sub_dict(blob, args.criterion_prefix)
    else:
        crit_sd = None

    # a pure weight conversion: the towers' configs alone, on the CPU (a
    # checkpoint restores onto any device)
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, "cpu")
    state = trainer.init_state()
    params = dual_encoder_params_from_torch(
        state.model, video_sd, text_sd, crit_sd, strict=not args.no_strict,
    )
    state.model.load_state_dict(params, strict=True)
    if state.ema is not None:
        # the imported weights are the history: the average starts there
        state.ema = {k: p.detach().clone()
                     for k, p in state.model.named_parameters()}

    CheckpointManager(args.output).save(0, state)
    n = sum(p.numel() for p in params.values())
    print(f"imported {n} parameters -> {args.output} (step 0)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
