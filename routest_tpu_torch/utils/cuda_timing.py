"""Device time of a function on the card, measured one way everywhere.

``chip_smoke.py``'s kernel phase and ``scripts/bench_serving_kernel_
cuda.py`` (which writes the records serving selects its kernel from)
time with these two helpers, so a record and a smoke run are read the
same way: CUDA events around many calls after a warm-up, either eager
calls (:func:`time_ms`, which also gives the host's cost to enqueue
one) or calls captured in one CUDA graph and replayed
(:func:`graph_ms`, the device time with no host work between calls).
Both need a card; ``torch`` is imported inside them. :func:`chip_peaks`
is the card's published peak table, which health reports.
"""

from __future__ import annotations

import time

# Published peaks of the cards the port runs on, by a substring of
# ``torch.cuda.get_device_name`` (lower case): (dense bf16 TFLOP/s, HBM
# GB/s) from NVIDIA's H100 data sheet, SXM part at its 700 W limit — the
# figures chip_smoke.py's bounds use.
_CHIP_PEAKS = {
    "h100 80gb hbm3": (989.0, 3350.0),
    "h100 sxm": (989.0, 3350.0),
}


def chip_peaks(device_kind: str):
    """(peak_tflops_bf16, peak_hbm_gbps) of a card by its name, or (None,
    None) when the table does not know it (the CPU, another card)."""
    kind = (device_kind or "").lower()
    for key, peaks in _CHIP_PEAKS.items():
        if key in kind:
            return peaks
    return None, None


def time_ms(fn, iters):
    """→ (CUDA-event ms per call, host ms per call to enqueue it). The
    enqueue time is taken over a run short enough not to fill the launch
    queue, so it is the wrapper's own host cost."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 50
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, enqueue_ms


def graph_ms(fn, reps=20, replays=10):
    """→ device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. With no host
    work between launches this is the kernel's own time (plus the
    graph's launch gap), where back-to-back eager launches would measure
    the wrapper's host cost whenever that is the longer of the two."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)
