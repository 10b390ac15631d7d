"""CLI: ``python -m routest_tpu_torch.analysis [--gate] [--json] [--rule …]``.

Exit codes: 0 = clean (in ``--gate`` mode: zero unbaselined findings
AND a structurally valid baseline), 1 = findings / invalid baseline,
2 = usage error. Human output is one ``file:line: [rule] severity:
message (fix: hint)`` diagnostic per finding; ``--json`` emits the full
machine-readable result instead.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from routest_tpu_torch.analysis.engine import (
    all_rules, analyze, load_corpus,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m routest_tpu_torch.analysis",
        description="rtpulint: invariant lints + registry drift "
                    "detectors for the routest-tpu PyTorch port")
    parser.add_argument("--gate", action="store_true",
                        help="CI mode: fail on any unbaselined finding "
                             "or invalid baseline entry")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable result")
    parser.add_argument("--rule", action="append", default=None,
                        metavar="ID",
                        help="run only this rule (repeatable)")
    parser.add_argument("--root", default=None,
                        help="repo root (default: the checkout holding "
                             "routest_tpu_torch/)")
    parser.add_argument("--baseline", default=None,
                        help="baseline path (default: "
                             "routest_tpu_torch/analysis/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report baselined findings as findings")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule_id, rule in sorted(all_rules().items()):
            print(f"{rule_id} [{rule.severity}]\n    {rule.description}")
        return 0

    t0 = time.perf_counter()
    try:
        corpus = load_corpus(args.root)
        result = analyze(corpus, rules=args.rule,
                         baseline_path=args.baseline,
                         use_baseline=not args.no_baseline)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - t0

    if args.json:
        out = result.as_dict()
        out["elapsed_s"] = round(elapsed, 3)
        print(json.dumps(out, indent=2))
    else:
        for f in result.findings:
            print(f.format())
        for err in result.baseline_errors:
            print(f"baseline: error: {err}")
        for e in result.stale_baseline:
            print(f"baseline: stale entry {e.rule} {e.file}:{e.line} "
                  f"(matches nothing — prune it)")
        verdict = "GATE OK" if result.gate_ok else (
            f"{len(result.findings)} finding(s)"
            + (f", {len(result.baseline_errors)} baseline error(s)"
               if result.baseline_errors else ""))
        print(f"rtpulint: {verdict} — {result.files_scanned} files, "
              f"{len(result.rules_run)} rules, "
              f"{len(result.baselined)} baselined, "
              f"{len(result.suppressed)} suppressed, "
              f"{elapsed:.2f}s")
    return 0 if result.gate_ok else 1


if __name__ == "__main__":
    sys.exit(main())
