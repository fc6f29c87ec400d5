"""``python -m jimm_tpu_torch cascade``: fit and inspect cascade
calibrations; the counterpart of ``jimm_tpu/serve/cascade/cli.py``.

Two verbs, torch-free (numpy and the stdlib: this runs on an operator's
laptop or in CI, not only on the serving machine):

- ``calibrate`` -- fit the confidence threshold from a holdout file of
  cheap/reference score rows for a target top-1 disagreement rate and
  persist it as a content-addressed artifact on the AOT store; prints
  the fingerprint a router loads it by.
- ``ls``        -- list the calibrations resident on a store.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["add_cascade_parser", "cmd_cascade"]


def _load_holdout(path: str) -> tuple:
    """(cheap, reference) score rows from a holdout file: ``.npz`` with
    ``cheap``/``reference`` arrays, or ``.json`` with the same keys as
    nested lists."""
    if path.endswith(".npz"):
        import numpy as np
        data = np.load(path)
        keys = set(data.files)
    else:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        keys = set(data)
    missing = {"cheap", "reference"} - keys
    if missing:
        raise ValueError(f"{path}: holdout missing {sorted(missing)} "
                         f"(has {sorted(keys)})")
    return data["cheap"], data["reference"]


def _cmd_calibrate(args) -> int:
    from jimm_tpu_torch.aot.store import ArtifactStore
    from jimm_tpu_torch.serve.cascade.calibrate import (fit_from_logits,
                                                  save_calibration)
    try:
        cheap, reference = _load_holdout(args.holdout)
        calib = fit_from_logits(
            cheap, reference, cheap_model=args.cheap_model,
            reference_model=args.reference_model,
            target_disagreement=args.target_disagreement)
    except (OSError, ValueError) as e:
        print(f"calibration failed: {e}", file=sys.stderr)
        return 1
    fingerprint = save_calibration(ArtifactStore(args.store), calib)
    if args.json:
        print(json.dumps(dict(calib.to_dict(), fingerprint=fingerprint),
                         indent=2, sort_keys=True))
        return 0
    print(f"calibration {calib.cheap_model} -> {calib.reference_model} "
          f"over {calib.holdout} holdout rows:")
    print(f"  temperature            {calib.temperature:g}")
    print(f"  threshold              {calib.threshold:g}")
    print(f"  measured disagreement  {calib.measured_disagreement:.4f} "
          f"(target {calib.target_disagreement:g})")
    print(f"  escalation fraction    {calib.escalation_fraction:.4f}")
    print(f"  fingerprint            {fingerprint}")
    return 0


def _cmd_ls(args) -> int:
    from jimm_tpu_torch.aot.store import ArtifactStore
    from jimm_tpu_torch.serve.cascade.calibrate import list_calibrations
    rows = list_calibrations(ArtifactStore(args.store))
    if args.json:
        print(json.dumps(rows, indent=2, sort_keys=True))
        return 0
    if not rows:
        print(f"no calibrations in {args.store}")
        return 0
    print(f"  {'label':<28} {'thresh':>8} {'temp':>8} {'disagree':>9} "
          f"{'escalate':>9}  fingerprint")
    for r in rows:
        print(f"  {str(r['label']):<28} {r['threshold']:>8g} "
              f"{r['temperature']:>8g} {r['measured_disagreement']:>9.4f} "
              f"{r['escalation_fraction']:>9.4f}  "
              f"{r['fingerprint'][:16]}…")
    return 0


def add_cascade_parser(subparsers) -> None:
    """Attach the ``cascade`` subcommand tree to the main CLI."""
    p = subparsers.add_parser(
        "cascade", help="fit and inspect cascade confidence calibrations")
    p.set_defaults(func=cmd_cascade)
    sub = p.add_subparsers(dest="cascade_cmd", required=True)

    pc = sub.add_parser(
        "calibrate",
        help="fit a confidence threshold from a holdout file and persist "
             "it on the AOT store")
    pc.add_argument("holdout",
                    help=".npz or .json with cheap/reference score rows")
    pc.add_argument("--cheap-model", required=True,
                    help="pool name of the cheap (narrow-dtype) model")
    pc.add_argument("--reference-model", required=True,
                    help="pool name of the reference (wide-dtype) model")
    pc.add_argument("--target-disagreement", type=float, default=0.01,
                    help="max top-1 disagreement on accepted answers "
                         "(default 0.01)")
    pc.add_argument("--store", required=True,
                    help="AOT artifact store root to persist into")
    pc.add_argument("--json", action="store_true",
                    help="print the calibration as JSON")
    pc.set_defaults(cascade_func=_cmd_calibrate)

    pl = sub.add_parser("ls", help="list calibrations on a store")
    pl.add_argument("--store", required=True,
                    help="AOT artifact store root to list")
    pl.add_argument("--json", action="store_true",
                    help="print the listing as JSON")
    pl.set_defaults(cascade_func=_cmd_ls)


def cmd_cascade(args) -> int:
    return args.cascade_func(args)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m jimm_tpu_torch.serve.cascade.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    add_cascade_parser(sub)
    args = parser.parse_args(argv)
    return cmd_cascade(args)


if __name__ == "__main__":
    raise SystemExit(main())
