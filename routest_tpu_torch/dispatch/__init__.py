"""Dispatch: batched VRP serving with live re-optimization, on the card.

The counterpart of ``routest_tpu/dispatch``:

- ``batcher.py``  — concurrent ``POST /api/dispatch`` requests merge
  into one padded batch through the dispatch solver
  (``optimize/vrp.py::solve_host_dispatch_batch``, time windows and the
  demand-spillover lane) on the serving device;
- ``registry.py`` — confirmed dispatches register their corridor,
  plan, baseline cost, SSE channel and replay seed;
- ``reopt.py``    — on every live-metric epoch flip, corridors
  re-price; plans degraded past the threshold re-solve in one batched
  pass and the update streams out as a ``plan_update`` SSE event.

Serving wiring lives in ``serve/app.py`` (``/api/dispatch``); knobs are
``RTPU_DISPATCH_*`` (``core/config.py``). The chaos points
``dispatch.solve`` and ``dispatch.resolve``, the ``dispatch.batch_solve``
span and the ``dispatch_solve`` / ``dispatch_reopt`` goodput records are
the JAX package's.
"""

from routest_tpu_torch.dispatch.batcher import (DispatchBatcher,
                                                DispatchProblem)
from routest_tpu_torch.dispatch.registry import (ActiveDispatch,
                                                 DispatchRegistry)
from routest_tpu_torch.dispatch.reopt import ReoptLoop, plan_cost

__all__ = [
    "ActiveDispatch",
    "DispatchBatcher",
    "DispatchProblem",
    "DispatchRegistry",
    "ReoptLoop",
    "plan_cost",
]
