"""``python -m jimm_tpu_torch qos`` — inspect and validate QoS policy
files; the counterpart of ``jimm_tpu/serve/qos/cli.py``.

Two verbs, stdlib only (no torch import: this runs on an operator laptop
or in a CI job):

- ``ls``       — parse a policy file and print its classes and tenants as
  a table (or ``--json`` for the machine-readable form).
- ``validate`` — parse and exit 0 on a clean policy, 1 with every problem
  listed on a malformed one (the pre-deploy gate).

Wired as a subparser under the port's CLI (``jimm_tpu_torch/cli.py``).
"""

from __future__ import annotations

import argparse
import json
import sys

from jimm_tpu_torch.serve.qos.policy import QosPolicyError, load_policy

__all__ = ["add_qos_parser", "cmd_qos"]


def _fmt(value) -> str:
    return "-" if value is None else f"{value:g}" if isinstance(
        value, float) else str(value)


def _cmd_ls(args) -> int:
    try:
        registry = load_policy(args.policy)
    except QosPolicyError as e:
        print(f"invalid policy {args.policy}: {e}", file=sys.stderr)
        return 1
    desc = registry.describe()
    if args.json:
        print(json.dumps(desc, indent=2, sort_keys=True))
        return 0
    print(f"policy: {args.policy}")
    print("\nclasses (priority order; rank 0 shed last):")
    print(f"  {'name':<16} {'weight':>8} {'rank':>5}")
    for c in desc["classes"]:
        print(f"  {c['name']:<16} {c['weight']:>8g} {c['rank']:>5}")
    print("\ntenants:")
    header = (f"  {'name':<16} {'class':<14} {'rate/s':>8} {'burst':>7} "
              f"{'timeout_s':>10} {'max_queued':>11}")
    print(header)
    rows = desc["tenants"] + [dict(desc["default"],
                                   name=f"({desc['default']['name']})")]
    for t in rows:
        print(f"  {t['name']:<16} {t['klass']:<14} {_fmt(t['rate']):>8} "
              f"{_fmt(t['burst']):>7} {_fmt(t['timeout_s']):>10} "
              f"{_fmt(t['max_queued']):>11}")
    return 0


def _cmd_validate(args) -> int:
    try:
        registry = load_policy(args.policy)
    except QosPolicyError as e:
        print(f"INVALID {args.policy}")
        for problem in str(e).split("; "):
            print(f"  - {problem}")
        return 1
    print(f"OK {args.policy}: {len(registry.classes)} classes, "
          f"{len(registry.tenants)} tenants "
          f"(+ default -> {registry.default.klass!r})")
    return 0


def add_qos_parser(subparsers) -> None:
    """Attach the ``qos`` subcommand tree to the main CLI's subparsers."""
    p = subparsers.add_parser(
        "qos", help="inspect and validate serving QoS policy files")
    p.set_defaults(func=cmd_qos)
    sub = p.add_subparsers(dest="qos_cmd", required=True)

    pl = sub.add_parser("ls", help="print a policy's classes and tenants")
    pl.add_argument("policy", help="policy file (.json or .toml)")
    pl.add_argument("--json", action="store_true",
                    help="print the parsed policy as JSON")
    pl.set_defaults(qos_func=_cmd_ls)

    pv = sub.add_parser("validate",
                        help="exit 0 iff the policy file is well-formed")
    pv.add_argument("policy", help="policy file (.json or .toml)")
    pv.set_defaults(qos_func=_cmd_validate)


def cmd_qos(args) -> int:
    return args.qos_func(args)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="jimm-tpu-torch-qos")
    sub = parser.add_subparsers(dest="command", required=True)
    add_qos_parser(sub)
    args = parser.parse_args(argv)
    return cmd_qos(args)


if __name__ == "__main__":
    raise SystemExit(main())
