"""routest_tpu_torch — the PyTorch/CUDA port of ``routest_tpu``.

The JAX package stays the reference; this package grows beside it slice
by slice and keeps its module paths and names, so every module here has
a counterpart at the same path under ``routest_tpu/``. It imports
``torch`` and never ``jax``, ``flax`` or ``routest_tpu``.

Slice 1 serves ETA scoring end to end: the 12-feature ABI encoder
(``data``), the ``RTPU1`` artifact reader (``train.checkpoint``), the
ETA-MLP (``models``), the hand-written CUDA kernel that fuses the whole
forward (``ops``), and the batcher, fast lane and HTTP surface
(``serve``). Slice 2 serves route optimization (``optimize``: the
greedy VRP, its refiners, top-k ranking and the GeoJSON engine), and
slice 3 street-network routing (``optimize.road_router`` over
``data.road_graph``/``data.osm``, priced by ``models.gnn`` and
``models.route_transformer``), then metro-scale routing
(``optimize.hierarchy``), the live loop (``serve.bus``, ``serve.sim``,
``live``) and dispatch (``dispatch``: the batched time-window VRP,
confirmed-route registration and live re-optimization) with the
dispatcher's pages and ops routes. Entry points run on ``cuda`` unless
the caller asks for the CPU.
"""

__version__ = "0.1.0"
