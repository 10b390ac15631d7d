"""Route-transformer training on one device: ``python -m
routest_tpu_torch.train.transformer``.

The single-device counterpart of ``scripts/train_transformer.py``:
random-walk routes over the exact routable graph a server aggregates
(the road router's post-bridge edge set, so the artifact passes its
fingerprint gate), routes observed at the hours 7, 12 and 17 held out
of training, then RMSE in seconds against naive physics and the noise
floor on held-out routes and hours. AdamW on ``cosine_decay(3e-4,
steps)`` with weight decay 1e-4, batches drawn by
``np.random.default_rng(2)``, as the JAX script.

    python -m routest_tpu_torch.train.transformer [--nodes 2048]
        [--steps 300] [--routes 768] [--seq-len 24] [--batch 128]
        [--subdivide K] [--osm PATH] [--save PATH | --no-save]
        [--report-out PATH] [--quick] [--device cuda|cpu]

The artifact goes to ``--save`` (or ``ROUTE_TRANSFORMER_PATH``) and
never over an artifact the JAX package ships; the report to
``artifacts/transformer_report_cuda.json`` unless ``--report-out``
names another path.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

HELD_OUT_HOURS = (7, 12, 17)  # same non-circular protocol as train.gnn


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m routest_tpu_torch.train.transformer")
    parser.add_argument("--nodes", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--routes", type=int, default=768)
    parser.add_argument("--seq-len", type=int, default=24)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--subdivide", type=int, default=0, metavar="K",
                        help="train on OSM-extract topology (K bend nodes "
                             "per street)")
    parser.add_argument("--osm", default=None, metavar="PATH")
    parser.add_argument("--save", default=None,
                        help="artifact path (default: "
                             "ROUTE_TRANSFORMER_PATH; unset = not saved)")
    parser.add_argument("--no-save", action="store_true")
    parser.add_argument("--report-out", default=None, metavar="PATH")
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.quick:
        args.nodes, args.steps, args.routes = 512, 80, 256
    return args


def _rmse(p, y, m) -> float:
    m = m.astype(bool)
    return float(np.sqrt(np.mean((p[m] - y[m]) ** 2)))


def train(args: argparse.Namespace) -> Dict:
    """One training run → the report dict (plus ``"_model"`` and
    ``"_graph"``)."""
    from routest_tpu_torch.core import prng
    from routest_tpu_torch.core.config import resolve_device
    from routest_tpu_torch.data.road_graph import generate_road_graph
    from routest_tpu_torch.models.route_transformer import (
        RouteTransformer, sample_route_sequences)
    from routest_tpu_torch.optimize.road_router import RoadRouter
    from routest_tpu_torch.train.loop import AdamW, cosine_decay_schedule
    from routest_tpu_torch.train.report import device_record

    dev = resolve_device(args.device, "train.transformer")
    if args.osm:
        from routest_tpu_torch.data.osm import load_osm

        router = RoadRouter(graph=load_osm(args.osm), use_gnn=False,
                            use_transformer=False, device=dev)
        print(f"[1/3] OSM graph {args.osm}: {router.n_nodes} nodes on {dev}")
    else:
        base = generate_road_graph(n_nodes=args.nodes, k=4, seed=0)
        if args.subdivide:
            from routest_tpu_torch.data.road_graph import subdivide_graph

            base = subdivide_graph(base, bends_per_edge=args.subdivide,
                                   oneway_frac=0.1, seed=0)
        router = RoadRouter(graph=base, use_gnn=False, use_transformer=False,
                            device=dev)
        print(f"[1/3] graph: {router.n_nodes} nodes on {dev}")
    graph = router.graph_dict()  # post-bridge: the serving fingerprint

    feats, freeflow, targets, mask, hours = sample_route_sequences(
        graph, args.routes, args.seq_len, seed=0, return_hours=True)
    ev_feats, ev_ff, ev_targets, ev_mask, ev_hours, ev_true = \
        sample_route_sequences(graph, max(128, args.routes // 4),
                               args.seq_len, seed=1, return_hours=True,
                               return_true=True)
    keep = ~np.isin(hours, HELD_OUT_HOURS)
    on_dev = {name: torch.from_numpy(a[keep]).to(dev) for name, a in (
        ("feats", feats), ("freeflow", freeflow), ("targets", targets),
        ("mask", mask))}
    n_train = int(keep.sum())
    print(f"      {n_train} train routes (hours "
          f"{list(HELD_OUT_HOURS)} held out), {len(ev_targets)} eval routes")

    model = RouteTransformer().init(prng.prng_key(0)).to(dev)
    optimizer = AdamW(list(model.parameters()),
                      cosine_decay_schedule(3e-4, args.steps), 1e-4)
    positions = torch.arange(args.seq_len, device=dev)

    print(f"[2/3] training {args.steps} steps (batch {args.batch}) on {dev}")
    rng = np.random.default_rng(2)
    t0 = time.perf_counter()
    for i in range(args.steps):
        idx = torch.from_numpy(rng.integers(0, n_train, args.batch)).to(dev)
        loss = model.loss(on_dev["feats"][idx], on_dev["freeflow"][idx],
                          positions, on_dev["targets"][idx],
                          on_dev["mask"][idx])
        optimizer.step(torch.autograd.grad(loss, optimizer.params))
        if (i + 1) % max(1, args.steps // 5) == 0:
            print(f"      step {i + 1}/{args.steps} "
                  f"loss={float(loss.detach()):.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0

    pred = model(torch.from_numpy(ev_feats).to(dev),
                 torch.from_numpy(ev_ff).to(dev), positions,
                 key_mask=torch.from_numpy(ev_mask).to(dev)).cpu().numpy()
    held = np.isin(ev_hours, HELD_OUT_HOURS)
    report = {
        "nodes": int(router.n_nodes),
        "routes": n_train,
        "seq_len": args.seq_len,
        "steps": args.steps,
        "transformer_rmse_s": _rmse(pred, ev_targets, ev_mask),
        "naive_rmse_s": _rmse(ev_ff, ev_targets, ev_mask),
        "noise_floor_rmse_s": _rmse(ev_true, ev_targets, ev_mask),
        "held_out_hours": list(HELD_OUT_HOURS),
        "transformer_rmse_held_hours_s": _rmse(
            pred[held], ev_targets[held], ev_mask[held]),
        "naive_rmse_held_hours_s": _rmse(
            ev_ff[held], ev_targets[held], ev_mask[held]),
        "noise_floor_held_hours_s": _rmse(
            ev_true[held], ev_targets[held], ev_mask[held]),
        "train_seconds": train_s,
        "ms_per_step": train_s * 1e3 / max(args.steps, 1),
        "device": device_record(dev),
    }
    report["vs_floor_held_hours"] = round(
        report["transformer_rmse_held_hours_s"]
        / max(report["noise_floor_held_hours_s"], 1e-9), 3)
    report["beats_naive"] = bool(
        report["transformer_rmse_s"] < report["naive_rmse_s"]
        and report["transformer_rmse_held_hours_s"]
        < report["naive_rmse_held_hours_s"])
    if args.subdivide:
        report["polyline_topology"] = {"bends_per_street": args.subdivide}
    if args.osm:
        report["osm"] = args.osm
    print(f"[3/3] eval: transformer {report['transformer_rmse_s']:.2f}s vs "
          f"naive {report['naive_rmse_s']:.2f}s (floor "
          f"{report['noise_floor_rmse_s']:.2f}s) | held-out hours: "
          f"{report['transformer_rmse_held_hours_s']:.2f}s vs "
          f"{report['naive_rmse_held_hours_s']:.2f}s | {train_s:.1f}s")
    report["_model"], report["_graph"] = model, graph
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    from routest_tpu_torch.train.checkpoint import save_transformer
    from routest_tpu_torch.train.report import (artifacts_path,
                                                refuse_jax_artifact,
                                                write_report)

    args = parse_args(argv)
    artifact = None if args.no_save else (
        args.save or os.environ.get("ROUTE_TRANSFORMER_PATH"))
    if artifact:
        refuse_jax_artifact(artifact)
    report = train(args)
    model, graph = report.pop("_model"), report.pop("_graph")
    out = write_report(args.report_out
                       or artifacts_path("transformer_report_cuda.json"),
                       report)
    print(f"      report → {out}")
    if artifact:
        save_transformer(artifact, model, graph, seq_len=args.seq_len)
        print(f"      artifact → {artifact}")
    return 0 if report["beats_naive"] else 1


if __name__ == "__main__":
    sys.exit(main())
