"""The JAX registry's probe verdict counts, left as a test found them.

``tests/test_prober.py`` reads ``rtpu_probe_checks_total`` of the JAX
package's process-wide registry absolutely (``== 0`` divergent route
verdicts). Under ``--dist loadfile`` a worker runs other files first in
the same process, so a port test file that drives the JAX prober must
hand the family back as it found it: :func:`restored` snapshots every
child's value and, on exit, drops the children that appeared and puts
the old values back.
"""

from __future__ import annotations

import contextlib

FAMILY = "rtpu_probe_checks_total"


def _registry():
    from routest_tpu.obs.registry import get_registry

    return get_registry()


def snapshot() -> dict:
    """{(probe, verdict): value} of the JAX family now ({} if absent)."""
    fam = _registry().get(FAMILY)
    return {} if fam is None else {k: c.value for k, c in fam.items()}


@contextlib.contextmanager
def restored():
    before = snapshot()
    try:
        yield before
    finally:
        fam = _registry().get(FAMILY)
        if fam is not None:
            with fam._lock:
                for key in list(fam._children):
                    if key not in before:
                        del fam._children[key]
                for key, child in fam._children.items():
                    with child._lock:
                        child.value = before[key]
