"""CUDA graphs captured per bucket at bring-up and replayed per request.

The port's form of the JAX package's ahead-of-time serving entries
(``jit().lower().compile()`` of a program per batch bucket): on the card
a program per bucket is a CUDA graph captured once, after warm-up
launches, and replayed on every request of exactly that bucket's size,
so a request pays one graph launch instead of each op's Python dispatch.

- :func:`capture` warms a function up on a side stream and captures one
  call of it. Captures are serialized process-wide (one capture at a
  time, whatever thread asks) and use ``capture_error_mode=
  "thread_local"``: a capture made while other threads serve (a hot
  swap's replacement, a second router) is not broken by their
  synchronising calls.
- :class:`BucketGraph` is one bucket of a host-in/host-out program: a
  static pinned input slab the rows are copied into, a replay that
  waits for its own work, and a static pinned output copied into a
  FRESH array. Its lock makes the static buffers single-use at a time
  (a graph is not reentrant, as a JAX executable is), and no caller
  ever holds a view of a static buffer — the port's form of the JAX
  batcher's slab-rotation safety.
- :class:`GraphTable` dispatches a batch of exactly a captured bucket's
  length to its graph and anything else to the eager scorer, as the
  JAX entry dispatches ``table.get(len(x))``. :meth:`GraphTable.release`
  frees the graphs under every bucket's lock: a replay in flight
  finishes first, and later calls score eagerly, so no replay runs into
  a freed pool.

Nothing here touches CUDA at import; the table's buffer discipline runs
on the CPU with a stand-in replay (the tests' twin of the JAX slab fuzz).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

# One capture at a time in the process: ``torch.cuda.graph`` syncs the
# device and empties the allocator's cache on entry, which must not run
# while another thread's capture is open.
_CAPTURE_LOCK = threading.Lock()


def capture(fn: Callable, device):
    """Warm ``fn()`` up twice on a side stream of ``device``,
    then capture one call into a CUDA graph → ``(graph, fn's output)``.
    The output's tensors are the graph's static buffers: each replay
    rewrites them in place. The graph is replayed once before it is
    returned, so its outputs hold a real run's values: a capture that
    follows, and reads them (the next segment of a program), warms up
    on valid indices and distances, not on uninitialized memory."""
    import torch

    with _CAPTURE_LOCK, torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            out = fn()
        graph.replay()
        return graph, out


class BucketGraph:
    """One bucket's captured host-in/host-out program.

    ``h_in`` / ``h_out``: numpy views of the static pinned input and
    output buffers; ``replay()``: launch the program and wait for its
    own work (:func:`replay_and_wait`). ``on_replay`` runs after each
    replay (launch accounting)."""

    __slots__ = ("bucket", "h_in", "h_out", "lock", "_replay",
                 "_on_replay", "_keep", "released")

    def __init__(self, bucket: int, h_in: np.ndarray, h_out: np.ndarray,
                 replay: Callable[[], None],
                 on_replay: Optional[Callable[[], None]] = None,
                 keep: tuple = ()) -> None:
        self.bucket = bucket
        self.h_in = h_in
        self.h_out = h_out
        self.lock = threading.Lock()
        self._replay = replay
        self._on_replay = on_replay
        self._keep = keep          # the graph and its device buffers
        self.released = False

    def run(self, x: np.ndarray) -> Optional[np.ndarray]:
        """Score ``x`` (exactly ``bucket`` rows) → a fresh array, or
        None once the graph is released (the caller scores eagerly)."""
        with self.lock:
            if self.released:
                return None
            self.h_in[...] = x
            self._replay()
            if self._on_replay is not None:
                self._on_replay()
            return self.h_out.copy()

    def release(self) -> None:
        with self.lock:
            self.released = True
            self._replay = self._on_replay = None
            self._keep = ()
            self.h_in = self.h_out = None


def replay_and_wait(graph) -> Callable[[], None]:
    """A replay of ``graph`` on the current stream that waits for that
    replay only (an event recorded after it), not the device."""
    import torch

    done = torch.cuda.Event()

    def replay() -> None:
        graph.replay()
        done.record()
        done.synchronize()

    return replay


class GraphTable:
    """Bucket → :class:`BucketGraph`, with the eager scorer for every
    other batch length."""

    def __init__(self, graphs: Dict[int, BucketGraph],
                 eager: Callable[[np.ndarray], np.ndarray]) -> None:
        self._graphs = dict(graphs)
        self._eager = eager

    @property
    def buckets(self) -> Tuple[int, ...]:
        return tuple(sorted(self._graphs))

    def __call__(self, x: np.ndarray) -> np.ndarray:
        entry = self._graphs.get(len(x))
        if entry is not None:
            out = entry.run(x)
            if out is not None:
                return out
        return self._eager(x)

    def release(self) -> None:
        """Free every graph (each under its bucket's lock)."""
        for entry in self._graphs.values():
            entry.release()


# ---------------------------------------------------------------------------
# Segmented programs: straight-line segments between host-checked loops.
# ---------------------------------------------------------------------------

def drive(counter, max_iters: int, sweeps: int,
          chunk: Callable[[], object]) -> bool:
    """The host side of a relaxation loop: ``chunk()`` runs ``sweeps``
    sweeps and returns the "changed" flag (a device tensor or a bool),
    read once per chunk — one host check, as long as it changed and
    fewer than ``max_iters`` sweeps ran. ``counter`` (a function object)
    counts its ``calls``, ``sweeps`` and ``checks``. → whether the last
    chunk still changed something."""
    counter.calls += 1
    it, changed = 0, True
    while changed and it < max_iters:
        flag = chunk()
        counter.sweeps += sweeps
        counter.checks += 1
        changed = bool(flag)
        it += sweeps
    return changed


class Loop:
    """A host-checked relaxation loop inside a program: ``chunk(carry)
    → (state, changed)`` runs ``sweeps`` sweeps from ``carry[key]``;
    :func:`drive` repeats it (``counter``, ``max_iters``)."""

    __slots__ = ("key", "chunk", "max_iters", "sweeps", "counter")

    def __init__(self, key: str, chunk: Callable, max_iters: int,
                 sweeps: int, counter) -> None:
        self.key = key
        self.chunk = chunk
        self.max_iters = max_iters
        self.sweeps = sweeps
        self.counter = counter


def run_steps(steps, carry: dict) -> dict:
    """Run a program eagerly: each step is a segment (``carry → carry``)
    or a :class:`Loop`."""
    for step in steps:
        if isinstance(step, Loop):
            box = [carry]

            def chunk(step=step, box=box):
                state, changed = step.chunk(box[0])
                box[0] = {**box[0], step.key: state}
                return changed

            drive(step.counter, step.max_iters, step.sweeps, chunk)
            carry = box[0]
        else:
            carry = step(carry)
    return carry


class CapturedProgram:
    """A program captured as CUDA graphs: one graph per run of
    consecutive segments, one per loop's chunk. ``inputs`` are static
    device tensors the caller fills before :meth:`run`. A chunk graph
    writes its state back into a buffer of its own (copied in by the
    graph before the loop) and its flag into a static tensor; the host
    drives the chunks with :func:`drive`, so the sweeps and checks are
    the eager program's, one for one. ``seconds`` is the capture time."""

    def __init__(self, steps, inputs: dict, device) -> None:
        import time

        t0 = time.perf_counter()
        self.inputs = inputs
        self._plan = []
        # Every carry between graphs, kept for the program's life: a
        # graph reads its predecessors' outputs (in their pools) and the
        # loop states (allocated outside any pool) at fixed addresses.
        self._keep: list = []
        carry = dict(inputs)
        segs: list = []
        for step in list(steps) + [None]:
            if step is not None and not isinstance(step, Loop):
                segs.append(step)
                continue
            carry = self._capture_segments(segs, step, carry, device)
            segs = []
            if step is not None:
                carry = self._capture_chunk(step, carry, device)
        self.out = carry
        self.seconds = time.perf_counter() - t0

    def _capture_segments(self, segs, loop, carry, device):
        if not segs and loop is None:
            return carry
        state = {}

        def body(carry_in=carry):
            c = run_steps(segs, carry_in)
            if loop is not None:
                buf = state.get("buf")
                if buf is None:        # first warm-up: outside capture
                    buf = state["buf"] = c[loop.key].clone()
                buf.copy_(c[loop.key])
                c = {**c, loop.key: buf}
            return c

        graph, out = capture(body, device)
        self._plan.append((graph, None, None))
        self._keep.append(out)
        return out

    def _capture_chunk(self, loop, carry, device):
        buf = carry[loop.key]

        def body():
            new, changed = loop.chunk(carry)
            buf.copy_(new)
            return changed

        graph, flag = capture(body, device)
        self._plan.append((graph, flag, loop))
        self._keep.append(flag)
        return carry

    def run(self) -> dict:
        """Replay the program on the current stream → the output carry
        (static tensors: read or copy them before the next run)."""
        for graph, flag, loop in self._plan:
            if loop is None:
                graph.replay()
                continue

            def chunk(graph=graph, flag=flag):
                graph.replay()
                return flag

            drive(loop.counter, loop.max_iters, loop.sweeps, chunk)
        return self.out

    def release(self) -> None:
        self._plan, self._keep = [], []
        self.inputs = self.out = None
