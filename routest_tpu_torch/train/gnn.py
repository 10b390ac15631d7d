"""Road-graph GNN training on one device: ``python -m
routest_tpu_torch.train.gnn``.

The single-device counterpart of ``scripts/train_gnn.py``: trains the
``RoadGNN`` on the exact routable graph a server aggregates over (the
road router's post-bridge edge set, so the artifact passes the serving
router's fingerprint gate) with targets from the congestion overlay,
and reports edge-time RMSE against naive physics (length / speed limit
+ 4 s) and the noise floor, on 10% held-out edges and on every edge at
the held-out hours 7, 12 and 17 (labels the loss never sees; those
edges still carry messages). AdamW on ``cosine_decay(3e-3, steps)``
with weight decay 1e-4 on every parameter, as the JAX script's optax
chain.

    python -m routest_tpu_torch.train.gnn [--nodes 2048] [--steps 400]
        [--hidden 64] [--samples 1] [--osm PATH] [--save PATH | --no-save]
        [--report-out PATH] [--quick] [--device cuda|cpu]

The artifact is written only to ``--save`` (or ``ROAD_GNN_PATH``), only
when the run beats naive physics, and never over an artifact the JAX
package ships. The report goes to ``artifacts/gnn_report_cuda.json``
unless ``--report-out`` names another path. Trains on the card unless
``--device cpu`` (or ``ROUTEST_DEVICE=cpu``) asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

HELD_OUT_HOURS = (7, 12, 17)  # labels never seen in training


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m routest_tpu_torch.train.gnn")
    parser.add_argument("--nodes", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--osm", default=None, metavar="PATH",
                        help="train on an OSM XML extract instead of the "
                             "generated graph")
    parser.add_argument("--save", default=None,
                        help="artifact path (default: ROAD_GNN_PATH; "
                             "unset = not saved)")
    parser.add_argument("--no-save", action="store_true")
    parser.add_argument("--samples", type=int, default=1,
                        help="observations per edge from the congestion "
                             "overlay (OSM extracts should use >= 3)")
    parser.add_argument("--report-out", default=None, metavar="PATH")
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.quick:
        args.nodes, args.steps = 512, 120
    return args


def train(args: argparse.Namespace) -> Dict:
    """One training run → the report dict (plus ``"_model"`` and
    ``"_graph"``, the trained module and its serving graph)."""
    from routest_tpu_torch.core import prng
    from routest_tpu_torch.core.config import resolve_device
    from routest_tpu_torch.data.road_graph import (add_congestion_observations,
                                                   generate_road_graph)
    from routest_tpu_torch.models.gnn import RoadGNN, graph_batch
    from routest_tpu_torch.optimize.road_router import RoadRouter
    from routest_tpu_torch.train.loop import AdamW, cosine_decay_schedule
    from routest_tpu_torch.train.report import device_record

    dev = resolve_device(args.device, "train.gnn")
    if args.osm:
        from routest_tpu_torch.data.osm import load_osm

        router = RoadRouter(graph=load_osm(args.osm), use_gnn=False,
                            use_transformer=False, device=dev)
        args.nodes = router.n_nodes
        print(f"[1/3] OSM graph {args.osm}: {router.n_nodes} nodes on {dev}")
    else:
        print(f"[1/3] graph: {args.nodes} nodes on {dev}")
        router = RoadRouter(
            graph=generate_road_graph(n_nodes=args.nodes, k=4, seed=0),
            use_gnn=False, use_transformer=False, device=dev)
    serving_graph = router.graph_dict()  # carries the fingerprint
    graph = add_congestion_observations(serving_graph, seed=0,
                                        samples_per_edge=args.samples)
    n_edges = len(graph["senders"])
    naive = graph["length_m"] / np.maximum(graph["speed_limit"], 0.1) + 4.0
    hh = np.isin(graph["hour"], HELD_OUT_HOURS)

    def floor(mask=slice(None)):
        return float(np.sqrt(np.mean(
            (graph["time_true_s"][mask] - graph["time_s"][mask]) ** 2)))

    print(f"      {n_edges} edges | naive-physics RMSE "
          f"{float(np.sqrt(np.mean((naive - graph['time_s']) ** 2))):.2f}s"
          f" | noise floor {floor():.2f}s")

    model = RoadGNN(n_nodes=args.nodes, hidden=args.hidden, n_rounds=2)
    model.init(prng.prng_key(0)).to(dev)
    optimizer = AdamW(list(model.parameters()),
                      cosine_decay_schedule(3e-3, args.steps), 1e-4)
    batch = graph_batch(graph, device=dev)
    coords = torch.from_numpy(np.asarray(graph["node_coords"],
                                         np.float32)).to(dev)
    # Held out of the loss AND of the messages, as in the JAX script:
    # 10% random edges, and every edge observed at a held-out hour.
    rng = np.random.default_rng(1)
    eval_mask = np.zeros(n_edges, bool)
    eval_mask[rng.choice(n_edges, size=max(1, n_edges // 10),
                         replace=False)] = True
    train_weights = (~(eval_mask | hh)).astype(np.float32)
    batch = batch._replace(weights=torch.from_numpy(train_weights).to(dev))

    print(f"[2/3] training {args.steps} steps on {dev}")
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss = model.loss(coords, batch)
        optimizer.step(torch.autograd.grad(loss, optimizer.params))
        if (i + 1) % max(1, args.steps // 5) == 0:
            print(f"      step {i + 1}/{args.steps} "
                  f"mse={float(loss.detach()):.2f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0

    with torch.no_grad():
        pred = model.predict(coords, batch.senders, batch.receivers,
                             batch.edge_feats, batch.length_m,
                             batch.speed_limit, weights=batch.weights
                             ).float().cpu().numpy()

    def rmse(values, mask):
        return float(np.sqrt(np.mean((values[mask]
                                      - graph["time_s"][mask]) ** 2)))

    held = eval_mask & ~hh
    report = {
        "nodes": args.nodes,
        "edges": n_edges,
        "steps": args.steps,
        "samples_per_edge": args.samples,
        "gnn_rmse_s": rmse(pred, held),
        "naive_rmse_s": rmse(naive, held),
        "held_out_hours": list(HELD_OUT_HOURS),
        "gnn_rmse_held_hours_s": rmse(pred, hh),
        "naive_rmse_held_hours_s": rmse(naive, hh),
        "noise_floor_rmse_s": floor(),
        "noise_floor_held_rmse_s": floor(held),
        "noise_floor_held_hours_rmse_s": floor(hh),
        "train_seconds": train_s,
        "ms_per_step": train_s * 1e3 / max(args.steps, 1),
        "device": device_record(dev),
    }
    report["vs_floor_held"] = report["gnn_rmse_s"] / \
        report["noise_floor_held_rmse_s"]
    report["vs_floor_held_hours"] = report["gnn_rmse_held_hours_s"] / \
        report["noise_floor_held_hours_rmse_s"]
    report["beats_naive"] = bool(
        report["gnn_rmse_s"] < report["naive_rmse_s"]
        and report["gnn_rmse_held_hours_s"]
        < report["naive_rmse_held_hours_s"])
    if args.osm:
        report["osm"] = args.osm
    print(f"[3/3] GNN held-out RMSE {report['gnn_rmse_s']:.2f}s (naive "
          f"{report['naive_rmse_s']:.2f}s) | held-out HOURS: GNN "
          f"{report['gnn_rmse_held_hours_s']:.2f}s vs naive "
          f"{report['naive_rmse_held_hours_s']:.2f}s | {train_s:.1f}s")
    report["_model"], report["_graph"] = model, serving_graph
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    from routest_tpu_torch.train.checkpoint import save_gnn
    from routest_tpu_torch.train.report import (artifacts_path,
                                                refuse_jax_artifact,
                                                write_report)

    args = parse_args(argv)
    artifact = None if args.no_save else (
        args.save or os.environ.get("ROAD_GNN_PATH"))
    if artifact:
        refuse_jax_artifact(artifact)
    report = train(args)
    model, graph = report.pop("_model"), report.pop("_graph")
    out = write_report(args.report_out
                       or artifacts_path("gnn_report_cuda.json"), report)
    print(f"      report → {out}")
    if artifact and report["beats_naive"]:
        save_gnn(artifact, model, graph)
        print(f"      artifact → {artifact}")
    elif artifact:
        print("      artifact NOT saved: run did not beat the naive baseline")
    return 0 if report["beats_naive"] else 1


if __name__ == "__main__":
    sys.exit(main())
