"""``python -m orp_tpu_torch.lint [--json|--format F] [--select RULES]
[--concurrency] [--changed [BASE]] [--list [--markdown]] [paths...]``
(counterpart of ``python -m orp_tpu.lint``, with its exit codes: 0 clean,
1 findings, 2 usage errors)."""

import argparse
import sys

from orp_tpu_torch.lint import RULES
from orp_tpu_torch.lint.engine import run_cli


def add_lint_arguments(p: argparse.ArgumentParser) -> None:
    """The lint CLI surface (the JAX package's flags, one definition for
    every entry point)."""
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories (default: the orp_tpu_torch package)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings document "
                        "(same as --format json)")
    p.add_argument("--format", dest="fmt", default=None,
                   choices=("human", "json", "sarif"),
                   help="output format; sarif emits a SARIF 2.1.0 document "
                        "for CI code annotations")
    p.add_argument("--select", default=None, metavar="ORP00X[,ORP00Y]",
                   help="run only these rules (ORP020-ORP022 route to the "
                        "project-wide concurrency pass)")
    p.add_argument("--concurrency", action="store_true",
                   help="also run the project-wide lock-discipline pass "
                        "(ORP020 guarded-by drift, ORP021 blocking under a "
                        "lock, ORP022 lock-order cycles) over the "
                        "serve/store/obs/guard/pilot planes")
    p.add_argument("--changed", nargs="?", const="HEAD", default=None,
                   metavar="BASE",
                   help="report only findings in files touched vs BASE "
                        "(default HEAD): the inner-edit-loop scope; the "
                        "concurrency pass still indexes project-wide")
    p.add_argument("--list", dest="list_rules", action="store_true",
                   help="list every rule and exit")
    p.add_argument("--markdown", action="store_true",
                   help="with --list: render the README rule table")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m orp_tpu_torch.lint",
        description="CUDA/H100-aware static analyzer "
                    f"({', '.join(sorted(RULES))} + concurrency rules "
                    "ORP020-ORP022)",
    )
    add_lint_arguments(p)
    args = p.parse_args(argv)
    return run_cli(args.paths, args.select, args.json, fmt=args.fmt,
                   concurrency=args.concurrency, changed=args.changed,
                   list_rules=args.list_rules, markdown=args.markdown)


if __name__ == "__main__":
    sys.exit(main())
