"""Command-line interface of the port (``multimodal_path_omic_tpu/cli.py``,
the same commands and flags). Every command runs on the GPU unless the
config says ``device: cpu`` (``--set device=cpu``):

    python -m multimodal_path_omic_tpu_torch.cli train --config cfg.yaml
    python -m multimodal_path_omic_tpu_torch.cli train --config cfg.yaml \\
        --set training.lr=1e-4 --set model.fusion=bilinear
    python -m multimodal_path_omic_tpu_torch.cli validate --config cfg.yaml \\
        --checkpoint checkpoints/NaCAGaT_...pt
    python -m multimodal_path_omic_tpu_torch.cli export-attn --config cfg.yaml \\
        --checkpoint ... --patient P013 --png
    python -m multimodal_path_omic_tpu_torch.cli predict --config cfg.yaml \\
        --checkpoint ... --out preds.csv [--mc 8]
    python -m multimodal_path_omic_tpu_torch.cli evaluate --config cfg.yaml \\
        --checkpoint ... --split val --json
    python -m multimodal_path_omic_tpu_torch.cli stratify --config cfg.yaml \\
        --checkpoint ... --png km.png
    python -m multimodal_path_omic_tpu_torch.cli convert-checkpoint --config cfg.yaml \\
        --torch-checkpoint ref.pt
    python -m multimodal_path_omic_tpu_torch.cli check-data --config cfg.yaml
    python -m multimodal_path_omic_tpu_torch.cli convert-bags --src bags/ --dst bags_npy/
    python -m multimodal_path_omic_tpu_torch.cli serve --config cfg.yaml \\
        --checkpoint ... --port 8008 --dynamic-batch 8
    python -m multimodal_path_omic_tpu_torch.cli bench --config cfg.yaml --epochs 5
    python -m multimodal_path_omic_tpu_torch.cli train --config cfg.yaml --profile-dir trace/
    python -m multimodal_path_omic_tpu_torch.cli profile --config cfg.yaml --top 20
    python -m multimodal_path_omic_tpu_torch.cli profile --trace-dir trace/
    python -m multimodal_path_omic_tpu_torch.cli plan --config cfg.yaml
    python -m multimodal_path_omic_tpu_torch.cli cv --config cfg.yaml --folds 5 \
        --out cv.json [--save-folds]
    python -m multimodal_path_omic_tpu_torch.cli sweep --config cfg.yaml \
        --grid training.lr=1e-4,2e-4 --grid model.fusion=concat,bilinear --out sweep.json
    python -m multimodal_path_omic_tpu_torch.cli export-model --config cfg.yaml \
        --checkpoint ... --out bundle/ --batch-sizes 1,8
    python -m multimodal_path_omic_tpu_torch.cli serve --bundle bundle/ --port 8008

On a mesh (``tpu.data_axis`` x ``tpu.seq_axis`` > 1) ``train``, ``validate``,
``predict``, ``evaluate``, ``stratify``, ``export-attn`` and ``serve`` run
under torchrun, one rank a GPU, and only rank 0 prints and writes files
(``serve``: rank 0 answers HTTP and hands each request to the other ranks,
``server.py``). ``export-attn`` runs on a seq axis (the export passes per
rank on merged statistics) and raises on a data axis > 1, as the JAX
package does (a batch of one bag does not split over it):

    torchrun --nproc-per-node 2 -m multimodal_path_omic_tpu_torch.cli train \\
        --config cfg.yaml --set tpu.data_axis=2
    torchrun --nproc-per-node 2 -m multimodal_path_omic_tpu_torch.cli serve \\
        --config mesh.yaml --checkpoint ... --port 8008   # mesh.yaml: tpu.data_axis: 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

def _parse_overrides(pairs: List[str], args=None) -> Dict[str, Any]:
    from multimodal_path_omic_tpu_torch.config import parse_cli_scalar

    overrides: Dict[str, Any] = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        key, value = pair.split("=", 1)
        overrides[key] = parse_cli_scalar(value)
    if args is not None and getattr(args, "bug_compat", False):
        overrides["training.bug_compat"] = True
    return overrides


def _config(args):
    from multimodal_path_omic_tpu_torch.config import load_config

    return load_config(args.config, _parse_overrides(args.set, args))


def _trainer(args):
    """A Trainer from the config, with ``--checkpoint`` restored or else
    ``--torch-checkpoint`` loaded."""
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    trainer = Trainer(_config(args))
    checkpoint = getattr(args, "checkpoint", None)
    if checkpoint:
        trainer.restore(checkpoint)
    elif args.torch_checkpoint:
        trainer.load_torch_checkpoint(args.torch_checkpoint)
    return trainer


def _print_metrics(result: Dict[str, float]) -> None:
    print({k: round(float(v), 6) for k, v in result.items()})


def cmd_train(args) -> int:
    trainer = _trainer(args)
    if args.profile_dir:  # a torch.profiler trace of the whole run (train/logging.py)
        from multimodal_path_omic_tpu_torch.train.logging import profile_trace

        with profile_trace(args.profile_dir):
            result = trainer.fit()
        print(f"trace written under {args.profile_dir}")
    else:
        result = trainer.fit()
    _print_metrics(result)
    return 0


def cmd_validate(args) -> int:
    _print_metrics(_trainer(args).validate("final validation"))
    return 0


def cmd_export_attn(args) -> int:
    args.set = list(args.set or []) + [f"training.leave_one_out={args.patient}"]
    _trainer(args).test(epoch=args.epoch, save=True, png=args.png)
    return 0


def cmd_predict(args) -> int:
    from multimodal_path_omic_tpu_torch.serve import Predictor

    predictor = Predictor.from_config(_config(args), checkpoint=args.checkpoint,
                                      torch_checkpoint=args.torch_checkpoint)
    path = predictor.predict_to_csv(args.out, mc_samples=args.mc, mc_seed=args.mc_seed)
    print(f"Predictions written to {path}")
    return 0


def cmd_stratify(args) -> int:
    """Risk stratification (train/analysis.py): KM groups + log-rank test."""
    from multimodal_path_omic_tpu_torch.train.analysis import stratify

    lead = _rank() == 0  # only rank 0 writes files
    result = stratify(_config(args), checkpoint=args.checkpoint,
                      torch_checkpoint=args.torch_checkpoint, quantile=args.quantile,
                      split=args.split, out_csv=args.out if lead else None,
                      png=args.png if lead else None, mc_samples=args.mc)
    if args.json:
        print(json.dumps({k: v for k, v in result.items() if k != "km"}))
    return 0


def cmd_evaluate(args) -> int:
    """The metric panel (train/analysis.py): c-index + IPCW Brier / IBS +
    AUC(t) (survival), or per-class precision / recall / F1 (GE)."""
    from multimodal_path_omic_tpu_torch.train.analysis import evaluate

    times = [float(x) for x in args.times.split(",")] if args.times else None
    result = evaluate(_config(args), checkpoint=args.checkpoint,
                      torch_checkpoint=args.torch_checkpoint, split=args.split,
                      eval_times=times)
    if args.json:
        print(json.dumps(result))
    return 0


def cmd_convert_checkpoint(args) -> int:
    """A reference .pt checkpoint saved as the port's checkpoint (under the
    config's model.checkpoint_dir)."""
    trainer = _trainer(args)
    # save() stores epoch + 1: starting_epoch - 1 round-trips, and a payload
    # without 'epoch' (starting_epoch 0) stores 0
    path = trainer.save(trainer.starting_epoch - 1, 0.0)
    print(f"Converted checkpoint written to {path}")
    return 0


def cmd_check_data(args) -> int:
    """Cohort preflight (data/check.py); exit 1 on a fatal issue."""
    from multimodal_path_omic_tpu_torch.data.check import check_data

    return 1 if check_data(_config(args))["fatal"] else 0


def cmd_convert_bags(args) -> int:
    """A reference bag store (.pt dir / .h5 file) as a per-slide .npy store."""
    from multimodal_path_omic_tpu_torch.data.bags import convert_bags

    convert_bags(args.src, args.dst, dtype=args.dtype)  # raises on 0 bags
    return 0


def cmd_bench(args) -> int:
    """Training throughput on the config's own cohort (``train/benchmark.py``):
    warm-up epochs, then timed ones; prints one JSON line."""
    from multimodal_path_omic_tpu_torch.config import load_config
    from multimodal_path_omic_tpu_torch.train.benchmark import benchmark_training

    cfg = load_config(args.config, _parse_overrides(args.set, args))
    benchmark_training(cfg, epochs=args.epochs, warmup=args.warmup, validate=args.validate)
    return 0


def cmd_cv(args) -> int:
    """Patient-level k-fold cross-validation (train/cv.py)."""
    from multimodal_path_omic_tpu_torch.train.cv import cross_validate, save_results

    folds = [int(x) for x in args.fold_indices.split(",")] if args.fold_indices else None
    result = cross_validate(_config(args), k=args.folds, fold_indices=folds,
                            save_folds=args.save_folds)
    save_results(result, args.out)
    return 0


def cmd_sweep(args) -> int:
    """Grid sweep (train/sweep.py): the cartesian product of the --grid
    axes, each a full training run, ranked best first."""
    from multimodal_path_omic_tpu_torch.train.sweep import run_sweep

    result = run_sweep(args.config, args.grid or [],
                       base_overrides=_parse_overrides(args.set, args), metric=args.metric)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


def cmd_plan(args) -> int:
    """Memory-fit report (train/plan.py); exit 1 when it does not fit."""
    from multimodal_path_omic_tpu_torch.train.plan import format_plan, memory_plan

    plan = memory_plan(_config(args))
    print(format_plan(plan))
    return 0 if plan["fits"] else 1


def cmd_profile(args) -> int:
    """Trace a short training run and print the ranked device-op report
    (train/profiling.py); ``--trace-dir`` alone reads an existing capture
    (``train --profile-dir``'s)."""
    from multimodal_path_omic_tpu_torch.train.profiling import (
        format_report,
        parse_trace,
        profile_training,
    )
    from multimodal_path_omic_tpu_torch.train.trainer import Trainer

    if args.config is None:
        if not args.trace_dir:
            print("profile: need --config (capture + analyze) or --trace-dir")
            return 1
        print(format_report(parse_trace(args.trace_dir, steps=args.steps or None),
                            top=args.top))
        return 0
    cfg = _config(args)
    trace_dir = args.trace_dir or os.path.join(cfg.training.checkpoint_dir or ".",
                                               "profile_trace")
    profile_training(Trainer(cfg), trace_dir, epochs=args.epochs, top=args.top)
    print(f"trace kept at {trace_dir}")
    return 0


def cmd_export_model(args) -> int:
    """Export the trained model as a deployment bundle (deploy.py)."""
    from multimodal_path_omic_tpu_torch.deploy import export_model

    if not (args.checkpoint or args.torch_checkpoint or args.allow_untrained):
        # unlike validate / predict, this mints a deployment artifact: a
        # bundle of random weights looks valid and serves garbage
        raise SystemExit("export-model without --checkpoint/--torch-checkpoint would bundle "
                         "RANDOM weights; pass --allow-untrained if that is really what you "
                         "want")
    manifest = export_model(
        _trainer(args), args.out,
        batch_sizes=tuple(int(x) for x in args.batch_sizes.split(",")),
        platforms=tuple(args.platforms.split(",")) if args.platforms else None,
        max_bag=args.max_bag, weights_dtype=args.weights_dtype)
    print(f"Exported {len(manifest['artifacts'])} programs ({manifest['model']}, buckets "
          f"{manifest['buckets']}, batch sizes {manifest['batch_sizes']}) to {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="multimodal_path_omic_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p, config_required: bool = True):
        p.add_argument("--config", required=config_required,
                       help="YAML config (reference schema)")
        p.add_argument("--set", action="append", metavar="KEY=VALUE",
                       help="dotted config override, e.g. training.lr=1e-4")
        p.add_argument("--torch-checkpoint", help="reference .pt checkpoint to load")
        p.add_argument(
            "--bug-compat", action="store_true",
            help="replicate the reference's bugs exactly (unseeded split, "
            "misaligned signature subsets, frozen fusion gates) for A/B studies",
        )

    def command(name, fn, help_text, **kw):
        p = sub.add_parser(name, help=help_text)
        common(p, **kw)
        p.set_defaults(fn=fn)
        return p

    p = command("train", cmd_train, "train a model (mcat/nacagat/ge_nacagat)")
    p.add_argument("--profile-dir", help="capture a torch.profiler trace of the run here")

    p = command("validate", cmd_validate, "run validation only")
    p.add_argument("--checkpoint", help="checkpoint to restore")

    p = command("export-attn", cmd_export_attn, "leave-one-out attention export")
    p.add_argument("--checkpoint")
    p.add_argument("--patient", required=True)
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--png", action="store_true",
                   help="also render each exported map as a heatmap/profile PNG")

    p = command("predict", cmd_predict, "batch inference -> CSV")
    p.add_argument("--checkpoint", action="append",
                   help="checkpoint; repeat to average a checkpoint ENSEMBLE")
    p.add_argument("--out", required=True, help="output CSV path")
    p.add_argument("--mc", type=int, default=0,
                   help="MC-dropout samples: add risk_mc_std / y_*_mc_std columns from N "
                   "stochastic forwards (0 = off)")
    p.add_argument("--mc-seed", type=int, default=0)

    p = command("convert-checkpoint", cmd_convert_checkpoint,
                "reference .pt -> the port's checkpoint")
    p.add_argument("--out", help="(unused; checkpoint_dir from config)")

    command("check-data", cmd_check_data,
            "cohort preflight: CSV schema, labels, signature coverage, bag store "
            "consistency (exit 1 on fatal issues)")

    p = command("stratify", cmd_stratify, "KM risk groups + log-rank test from a trained model")
    p.add_argument("--checkpoint", action="append", help="checkpoint; repeatable (ensemble)")
    p.add_argument("--quantile", type=float, default=0.5,
                   help="risk cut point (0.5 = median split)")
    p.add_argument("--split", default="val", choices=("val", "train", "all"))
    p.add_argument("--out", help="per-slide CSV (slide_id, risk, group, ...)")
    p.add_argument("--png", help="render the KM figure here")
    p.add_argument("--mc", type=int, default=0,
                   help="MC-dropout samples for risk_mc_std CSV column")
    p.add_argument("--json", action="store_true",
                   help="also print the result summary as one JSON line")

    p = command("evaluate", cmd_evaluate,
                "metric panel: c-index + IPCW Brier/IBS + AUC(t) (survival) or per-class "
                "P/R/F1 + confusion (GE)")
    p.add_argument("--checkpoint", action="append", help="checkpoint; repeatable (ensemble)")
    p.add_argument("--split", default="val", choices=("val", "train", "all"))
    p.add_argument("--times", help="comma-separated eval months (default: the cohort's qcut "
                   "bin edges)")
    p.add_argument("--json", action="store_true", help="also print the result as one JSON line")

    p = sub.add_parser("convert-bags",
                       help="reference .pt dir / .h5 file -> per-slide .npy store")
    p.add_argument("--src", required=True, help=".pt directory or .h5 file")
    p.add_argument("--dst", required=True, help="output .npy directory")
    p.add_argument("--dtype", default="float32", choices=("float32", "float16"))
    p.set_defaults(fn=cmd_convert_bags)

    p = command("sweep", cmd_sweep, "grid sweep: train the cartesian product of --grid "
                "axes, rank by the quality metric")
    p.add_argument("--grid", action="append", metavar="KEY=V1,V2,...",
                   help="dotted config key and its comma-separated values; repeat per axis")
    p.add_argument("--metric", help="rank key (default: val_c_index / val_accuracy)")
    p.add_argument("--out", help="write ranked results JSON")
    p = command("cv", cmd_cv, "patient-level k-fold cross-validation (mean ± std metric)")
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--out", help="write per-fold + aggregate results JSON")
    p.add_argument("--save-folds", action="store_true",
                   help="save each fold's model under <checkpoint_dir>/fold<i>/ (an "
                   "ensemble for predict / serve)")
    p.add_argument("--fold-indices", help="comma-separated folds to run (default: all)")
    p = command("export-model", cmd_export_model,
                "deployment bundle: one torch.export program per (bucket, batch size)")
    p.add_argument("--checkpoint")
    p.add_argument("--out", required=True, help="bundle directory")
    p.add_argument("--batch-sizes", default="1", help="comma-separated batch sizes")
    p.add_argument("--platforms", default=None,
                   help="devices to check the bundle on after export (cpu,cuda; default "
                   "the config's device)")
    p.add_argument("--max-bag", type=int, default=None,
                   help="largest bag to serve: export the rounded-up buckets beyond the "
                   "config's")
    p.add_argument("--allow-untrained", action="store_true",
                   help="export without a checkpoint (random weights)")
    p.add_argument("--weights-dtype", default="float32", choices=("float32", "bfloat16"),
                   help="bfloat16: the parameters stored in bfloat16, computed in float32")
    p = command("bench", cmd_bench, "steady-state training throughput on your config/data")
    p.add_argument("--epochs", type=int, default=5, help="timed epochs")
    p.add_argument("--warmup", type=int, default=1,
                   help="untimed epochs (kernel build, graph capture, cache upload)")
    p.add_argument("--validate", action="store_true",
                   help="time validated epochs (training + validation)")
    command("plan", cmd_plan, "memory-fit report: will this config fit the device?")
    p = command("profile", cmd_profile,
                "trace a short training run and print a ranked device-op report",
                config_required=False)
    p.add_argument("--trace-dir", help="where to write the capture; alone (no --config): "
                   "read an existing capture")
    p.add_argument("--epochs", type=int, default=1,
                   help="traced epochs after the untraced warm-up epoch")
    p.add_argument("--steps", type=int, default=0,
                   help="with --trace-dir alone: per-step normalizer")
    p.add_argument("--top", type=int, default=25, help="ranked rows to print")

    # listed for --help; main() hands `serve` to the server before argparse
    sub.add_parser("serve", add_help=False,
                   help="HTTP scoring server (flags: --config --checkpoint | --bundle, --port "
                   "--warmup --dynamic-batch ...; see `serve --help`)")
    return parser


def _rank() -> int:
    """This process's rank under torchrun (0 otherwise)."""
    return int(os.environ.get("RANK", "0"))


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if _rank() != 0:  # under torchrun only rank 0 prints
        sys.stdout = open(os.devnull, "w")
    if argv[:1] == ["serve"]:
        # `cli serve ...` is `python -m multimodal_path_omic_tpu_torch.server ...`
        from multimodal_path_omic_tpu_torch import server

        return server.main(argv[1:])
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
