"""Command-line interface of the port (counterpart of ``tpu_unet/cli.py``):

    python -m tpu_unet_torch -m TRAINING -d DIC-C2DH-HeLa --synthetic --dtype bfloat16
    python -m tpu_unet_torch -m TESTING -d DIC-C2DH-HeLa --synthetic \\
        -n models/DIC-C2DH-HeLa/all/models/best --quant int8

The reference's seven flags (-m/--mode, -d/--dataset, -f/--folds,
-n/--network, -s/--seed, -sf/--start_from, -sk/--skip_fold) and the JAX
package's extras, with the same names, choices and defaults. TRAINING
trains on the whole set (validating on the gold-truth frames of the same
sequences) or runs seeded cross-validation folds; TESTING serves a
checkpoint directory or a reference ``.pth`` through the evaluation entry
point and exports the predictions.

It runs on the card (``--platform cuda``, the default) and exits, naming
``--platform cpu``, when there is none.

The parser takes every flag of the JAX package's, so that its command
lines run unchanged; ``--platform`` names this package's devices. The one
exception to "every flag acts": ``--compile-cache`` and
``--no-compile-cache`` set the JAX package's XLA compilation cache and do
nothing here, where the CUDA kernels are compiled once per source hash
into ``build/tpu_unet_torch/`` (``ops/_build.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from tpu_unet_torch.config import DATASETS, DatasetConfig, ModelConfig, TrainConfig


def tile_out_arg(v: str):
    """int ('516') or rectangular strip 'HxW' ('2372x1188')."""
    if "x" in v:
        h, w = v.split("x")
        return (int(h), int(w))
    return int(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-unet-torch",
        description="U-Net (Ronneberger et al. 2015) training/evaluation in PyTorch "
                    "and CUDA",
    )
    p.add_argument("-m", "--mode", required=True, choices=["TRAINING", "TESTING"])
    p.add_argument("-d", "--dataset", required=True,
                   choices=["DIC-C2DH-HeLa", "ISBI2012", "PhC-C2DH-U373", "synthetic"])
    p.add_argument("-f", "--folds", type=int, default=None,
                   help="cross-validation folds (<=5); omit to train on everything")
    p.add_argument("-n", "--network", type=str, default=None,
                   help="checkpoint directory or reference .pth to test (TESTING)")
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("-sf", "--start_from", action="store_true", default=False,
                   help="resume from the latest checkpoint in the run directory")
    p.add_argument("-sk", "--skip_fold", type=int, default=0)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--out-dir", default="models")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="use the deterministic synthetic fixture dataset")
    p.add_argument("--download", action="store_true",
                   help="fetch CTC/ISBI archives if missing (needs network)")
    p.add_argument("--width-mult", type=int, default=1)
    p.add_argument("--base-width", type=int, default=64)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    # default None so the .pth testing path can tell "user chose paper"
    # apart from "unset" (reference checkpoints need parity geometry).
    p.add_argument("--skip-variant", default=None, choices=["paper", "parity"])
    p.add_argument("--init", default="paper", choices=["paper", "parity"])
    p.add_argument("--tile-out", type=tile_out_arg, default=None,
                   help="overlap-tile output size for TESTING: an int, or "
                        "HxW for rectangular strip tiles (default: whole "
                        "image)")
    p.add_argument("--quant", default=None,
                   choices=["int8", "int8-phase", "int4", "int4-phase"],
                   help="TESTING: serve through the post-training-quantized "
                        "forward: 'int8' runs the convs of 128 or more input "
                        "channels in int8; 'int8-phase' also runs level 0 "
                        "phase-packed, its packed convs in int8; 'int4' and "
                        "'int4-phase' run those convs outside level 0 in int4 "
                        "(w4a4, on the int8 library route: the card has no "
                        "int4 MMA). On an NVIDIA H100 80GB HBM3 at a 700 W "
                        "limit the int8 tiers are slower than bf16: 397.8 and "
                        "383.2 against 827.0 tiles/s for the bf16 'pallas' "
                        "model, and the int4 tiers slower still: 191.7 and "
                        "188.6 tiles/s (PERF.md)")
    p.add_argument("--phase-level0", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run level 0 of the trainable model phase-packed "
                        "(ModelConfig.phase_level0; same parameters, "
                        "checkpoint-compatible; needs conv_impl 'xla'). On by "
                        "default, as in the JAX package's CLI; on an NVIDIA "
                        "H100 80GB HBM3 at a 700 W limit a phase-packed "
                        "train step took 20.019 against 19.042 ms plain "
                        "(PERF.md). --no-phase-level0 restores the canonical "
                        "layout")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="the JAX package's XLA cache: no effect here, where "
                        "the CUDA kernels are cached per source hash in "
                        "build/tpu_unet_torch/")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="no effect here (see --compile-cache)")
    p.add_argument("--nan-check", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="device to run on (default: cuda; without a card pass "
                        "--platform cpu)")
    return p


def _load_data(args, ds_cfg):
    from tpu_unet_torch.data import (
        load_ctc_test,
        load_ctc_training,
        load_isbi_training,
        synthetic_dataset,
    )

    if args.synthetic or args.dataset == "synthetic":
        crop = ds_cfg.crop if args.dataset != "synthetic" else 196
        # fixture images must cover the crop window (HeLa/ISBI crop is 388);
        # 10 images give five distinct 5-fold splits
        side = max(256, crop + 60)
        train = synthetic_dataset(n_images=10, h=side, w=side, n_cells=5,
                                  crop=crop, seed=args.seed)
        return train, train
    root = os.path.join(args.data_dir, f"{args.dataset}-training")
    if not os.path.isdir(root):
        if args.download:
            from tpu_unet_torch.data.download import download_all
            download_all(args.data_dir)
        else:
            sys.exit(
                f"dataset directory {root} not found; pass --download (needs "
                f"network) or --synthetic for the fixture dataset")
    if ds_cfg.is_isbi:
        train = load_isbi_training(root, crop=ds_cfg.crop)
        test = load_isbi_training(root, crop=ds_cfg.crop)
    else:
        train = load_ctc_training(root, crop=ds_cfg.crop)
        test = load_ctc_test(root)
    return train, test


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.folds is not None and args.folds > 5:
        sys.exit("Input a FOLDS value below 5")

    import torch

    if args.platform == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --platform cpu to run on the CPU")
    device = torch.device(args.platform)

    if args.dataset == "synthetic":
        ds_cfg = DatasetConfig(name="synthetic", crop=196, metric="iou",
                               weight_mode="class_balance", goal=0.999,
                               goal_direction="max")
    else:
        ds_cfg = DATASETS[args.dataset]

    model_cfg = ModelConfig(
        base_width=args.base_width, width_mult=args.width_mult,
        skip_variant=args.skip_variant or "paper", init_scheme=args.init,
        compute_dtype=args.dtype, phase_level0=args.phase_level0,
    )
    train_kwargs = {}
    if args.batch_size:
        train_kwargs["batch_size"] = args.batch_size
    train_cfg = TrainConfig(seed=args.seed, **train_kwargs)

    if not args.quiet:
        print(f"tpu-unet-torch — U-Net on {device}")
        print(f"Mode: {args.mode}   Dataset: {args.dataset}   Seed: {args.seed}")

    if args.mode == "TRAINING":
        from tpu_unet_torch.train import Trainer
        from tpu_unet_torch.train.folds import fold_splits, subset

        train_data, test_data = _load_data(args, ds_cfg)

        def fit(out_dir, train, val):
            trainer = Trainer(ds_cfg, model_cfg=model_cfg, train_cfg=train_cfg,
                              out_dir=out_dir, verbose=not args.quiet,
                              nan_check=args.nan_check, device=device)
            trainer.fit(train, val, epochs=args.epochs, resume=args.start_from)

        if args.folds is None:
            fit(os.path.join(args.out_dir, ds_cfg.name, "all"), train_data, test_data)
        else:
            for fold, tr_idx, va_idx in fold_splits(
                    len(train_data), args.folds, args.seed, train_cfg.val_fraction):
                if fold < args.skip_fold:
                    if not args.quiet:
                        print(f"Skipping fold {fold}")
                    continue
                fit(os.path.join(args.out_dir, ds_cfg.name, f"fold{fold}"),
                    subset(train_data, tr_idx), subset(train_data, va_idx))
        return 0

    if args.network is None:
        sys.exit("Input a network path when calling the script")

    from tpu_unet_torch.infer import evaluate
    from tpu_unet_torch.models import UNet

    _, test_data = _load_data(args, ds_cfg)

    if args.network.endswith(".pth"):
        # A reference torch checkpoint. The reference trained with the
        # as-implemented skip geometry, so parity is the default here; an
        # explicit --skip-variant wins.
        from tpu_unet_torch.convert import load_reference_checkpoint

        model = UNet(ModelConfig(
            skip_variant=args.skip_variant or "parity",
            width_mult=args.width_mult, base_width=args.base_width,
            compute_dtype=args.dtype)).to(device)
        model.load_state_dict(load_reference_checkpoint(args.network))
        output_dir = args.network[:-4] + "_test"
    else:
        from tpu_unet_torch.train.checkpoint import Checkpointer

        # Self-describing checkpoints: the model config stored at save time
        # wins, but phase_level0 changes no parameter shape, so the flag
        # overrides the stored value.
        hs_path = os.path.join(os.path.abspath(args.network), "host_state.json")
        if os.path.exists(hs_path):
            with open(hs_path) as f:
                stored = json.load(f).get("model_cfg")
            if stored:
                stored["phase_level0"] = args.phase_level0
                model_cfg = ModelConfig(**stored)
        model = UNet(model_cfg).to(device)
        ckpt = Checkpointer(os.path.dirname(os.path.abspath(args.network)))
        state, _ = ckpt.restore(os.path.basename(args.network.rstrip("/")))
        model.load_state_dict(state["model"])
        output_dir = args.network.rstrip("/") + "_test"
    evaluate(model, test_data, output_dir=output_dir, tile_out=args.tile_out,
             verbose=not args.quiet, quant=args.quant)
    return 0


if __name__ == "__main__":
    sys.exit(main())
