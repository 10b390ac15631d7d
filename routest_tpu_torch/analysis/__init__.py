"""rtpulint for the PyTorch port: the project's static analysis over
``routest_tpu_torch/``.

``python -m routest_tpu_torch.analysis [--gate] [--json] [--rule ID
...]`` runs two rule families over the whole port in one process, one
AST parse per file (the JAX package keeps its own gate,
``python -m routest_tpu.analysis``):

- **Invariant lints** (pure AST): ``silent-except``, ``bare-print``,
  ``broad-except-unlogged``, ``blocking-call-under-lock``,
  ``thread-unmanaged``, and the capture hazards that replace the JAX
  ones: ``capture-impure-host-call``, ``capture-host-sync``,
  ``graph-static-output-reuse`` (``torchrules.py``).
- **Drift detectors** (code ↔ registry cross-reference):
  ``env-knob-undeclared`` / ``env-knob-undocumented`` (reads vs
  core/config.py and the docs knob tables), ``metric-undocumented`` /
  ``metric-stale-doc`` (registered families vs docs/OBSERVABILITY.md,
  both directions), ``api-route-undocumented`` (serve/ route strings
  vs docs/API.md), ``chaos-point-undocumented`` /
  ``chaos-point-collision`` (inject() names vs docs/ROBUSTNESS.md), and
  the ``ledger-kind-*`` trio. Each doc is the shared ``docs/<name>.md``
  joined with the port's ``docs/torch/<name>.md``.

Findings carry a rule id, severity, and a one-line fix hint;
grandfathered findings live in ``analysis/baseline.json`` (reason
required per entry); deliberate waivers use
``# rtpulint: disable=<rule> -- <reason>`` at the site. See
docs/ANALYSIS.md for the catalog and the adding-a-rule recipe.
"""

from routest_tpu_torch.analysis.engine import (  # noqa: F401
    AnalysisResult,
    Corpus,
    Finding,
    Rule,
    all_rules,
    analyze,
    load_baseline,
    load_corpus,
    repo_root,
)

__all__ = [
    "AnalysisResult",
    "Corpus",
    "Finding",
    "Rule",
    "all_rules",
    "analyze",
    "load_baseline",
    "load_corpus",
    "repo_root",
]
