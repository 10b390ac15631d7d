"""Workload models: what each scheduled arrival actually sends.

Uniform synthetic traffic (what ``scripts/load_test_cuda.py``'s
closed-loop phases generate) is the kindest possible workload: every
key is unique, so caches never help and never mislead, and every route
is exercised in proportion to nothing in particular. Real traffic is skewed — a few OD pairs carry
most of the demand (the head of a Zipf distribution), and a serving
stack's cache/batching behavior under that skew is a different system
than under uniform keys. This module produces that traffic:

- :class:`ZipfODWorkload` — OD pairs over the Manila extract
  (``data/locations.SEED_LOCATIONS``), rank-assigned by a seeded
  permutation and sampled Zipf(s). Each pair maps to ONE exact
  ``/api/predict_eta`` body (distance from the haversine between the
  endpoints, context fields derived from the pair index), so repeated
  draws of a hot pair are byte-identical — precisely what the fast
  lane's content-addressed prediction cache keys on.
- :class:`MixedWorkload` — a route mix with configurable ratios
  (predict / request_route / history / batch), each route drawing its
  bodies from the same seeded streams.

Determinism contract: ``sequence(n)`` for the same ``(model
parameters, seed)`` returns the same ``n`` requests, independent of
how many were drawn before — reports can say "identical offered
traffic" and mean it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from routest_tpu_torch.data.locations import SEED_LOCATIONS

_WEATHER = ("Sunny", "Cloudy", "Stormy", "Windy", "Fog")
_TRAFFIC = ("Low", "Medium", "High", "Jam")


@dataclasses.dataclass(frozen=True)
class PlannedRequest:
    """One unit of offered work: enough to send it and to label the
    result in the report.

    ``body`` is either a JSON-able dict (sent as application/json) or
    raw ``bytes`` (sent verbatim under ``content_type`` — the binary
    wire path, docs/API.md "Binary wire format")."""

    method: str
    path: str
    body: Optional[object]      # dict (JSON) | bytes (pre-encoded)
    route: str                  # report label (path sans query/params)
    content_type: str = "application/json"


def _haversine_m(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
    r = 6_371_000.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) \
        * math.sin(dl / 2) ** 2
    return 2 * r * math.asin(math.sqrt(a))


class ZipfODWorkload:
    """Zipf-distributed OD pairs → byte-stable ``/api/predict_eta``
    bodies.

    All ordered pairs over the 21 Manila sites (420) are ranked by a
    seeded permutation (so rank ≠ geography), then sampled with
    ``P(rank k) ∝ k^-s``. ``s≈1.1`` gives the textbook "top 1% of keys
    ≈ one third of traffic" skew; ``s=0`` degrades to uniform."""

    def __init__(self, s: float = 1.1, seed: int = 0,
                 locations: Sequence[Tuple[str, float, float]] =
                 SEED_LOCATIONS) -> None:
        if s < 0:
            raise ValueError("zipf exponent must be >= 0")
        self.s = s
        self.seed = seed
        self.pairs: List[Tuple[int, int]] = [
            (i, j) for i in range(len(locations))
            for j in range(len(locations)) if i != j]
        self._locations = tuple(locations)
        rng = np.random.default_rng(seed)
        self._rank_to_pair = rng.permutation(len(self.pairs))
        ranks = np.arange(1, len(self.pairs) + 1, dtype=np.float64)
        pmf = ranks ** -s
        self._pmf = pmf / pmf.sum()

    def pair_indices(self, n: int, seed_offset: int = 1) -> np.ndarray:
        """``n`` sampled pair ids (deterministic; a fresh generator per
        call so the sequence never depends on prior draws)."""
        rng = np.random.default_rng((self.seed, seed_offset))
        ranks = rng.choice(len(self.pairs), size=n, p=self._pmf)
        return self._rank_to_pair[ranks]

    def body_for_pair(self, pair_id: int) -> dict:
        """The ONE body this pair always produces (byte-stable →
        cache-keyable). Context fields hash off the pair id, distance
        is the real haversine between the endpoints."""
        i, j = self.pairs[int(pair_id)]
        _, lat1, lon1 = self._locations[i]
        _, lat2, lon2 = self._locations[j]
        return {
            "summary": {"distance": round(_haversine_m(lat1, lon1,
                                                       lat2, lon2), 1)},
            "weather": _WEATHER[pair_id % len(_WEATHER)],
            "traffic": _TRAFFIC[pair_id % len(_TRAFFIC)],
            "driver_age": 25.0 + (pair_id % 30),
            "pickup_time": "2026-08-04T18:00:00",
        }

    def sequence(self, n: int) -> List[PlannedRequest]:
        return [PlannedRequest("POST", "/api/predict_eta",
                               self.body_for_pair(p), "/api/predict_eta")
                for p in self.pair_indices(n)]

    def route_body_for_pair(self, pair_id: int, stops: int = 2,
                            road_graph: bool = False) -> dict:
        """A ``/api/request_route``-shaped body over the same pair
        vocabulary (source = pair's origin, destinations walk the
        location list from the pair's target). ``road_graph=True``
        routes over the street network (true shortest paths through
        the partition overlay) instead of great-circle legs — the
        metro-extract serving workload."""
        i, j = self.pairs[int(pair_id)]
        _, lat1, lon1 = self._locations[i]
        dests = []
        for k in range(stops):
            _, lat, lon = self._locations[(j + k) % len(self._locations)]
            dests.append({"lat": lat, "lon": lon, "payload": 1})
        body = {
            "source_point": {"lat": lat1, "lon": lon1},
            "destination_points": dests,
            "driver_details": {"vehicle_type": "car",
                               "vehicle_capacity": 100,
                               "maximum_distance": 300_000},
            "use_ml_eta": True,
        }
        if road_graph:
            body["road_graph"] = True
        return body

    def dispatch_body_for_pair(self, pair_id: int,
                               stops: int = 4) -> dict:
        """A ``/api/dispatch``-shaped body over the same pair
        vocabulary: the depot is the pair's Zipf-sampled origin, the
        stop set walks the location list from the pair's target, and
        payloads hash off ``(pair_id, k)`` — so a hot depot repeats as
        a byte-identical dispatch problem (the batcher merges them
        into one device batch)."""
        i, j = self.pairs[int(pair_id)]
        _, lat1, lon1 = self._locations[i]
        dests = []
        for k in range(stops):
            _, lat, lon = self._locations[(j + k) % len(self._locations)]
            dests.append({"lat": lat, "lon": lon,
                          "payload": 1 + (pair_id + k) % 3})
        return {
            "source_point": {"lat": lat1, "lon": lon1},
            "destination_points": dests,
            "driver_details": {"vehicle_type": "car",
                               "vehicle_capacity": 6,
                               "maximum_distance": 300_000},
        }


DEFAULT_MIX: Dict[str, float] = {
    "predict_eta": 0.85,
    "request_route": 0.05,
    "history": 0.10,
}


class MixedWorkload:
    """Route mix with configurable ratios over seeded body streams.

    ``mix`` maps route kind → weight (normalized internally). Kinds:
    ``predict_eta`` (Zipf OD single rows), ``request_route`` (the
    routing path over the same OD vocabulary), ``history`` (GET reads),
    ``predict_eta_batch`` (columnar batches of ``batch_rows`` Zipf
    rows), ``dispatch`` (VRP dispatch problems with Zipf depots and
    byte-stable stop sets). SSE streams are long-lived connections,
    not arrivals — the engine holds those separately
    (``engine.SseClients``)."""

    KINDS = ("predict_eta", "request_route", "history",
             "predict_eta_batch", "update_tracker", "probe", "dispatch")

    def __init__(self, mix: Optional[Dict[str, float]] = None,
                 s: float = 1.1, seed: int = 0,
                 batch_rows: int = 64,
                 sse_channel: str = "loadgen",
                 road_graph: bool = False,
                 probe_edges: int = 0,
                 probe_obs: int = 4,
                 route_zipf_s: Optional[float] = None,
                 route_stops: int = 2,
                 dispatch_stops: int = 4,
                 regions: Optional[Sequence[str]] = None,
                 region_zipf_s: float = 1.1,
                 wire_format: str = "json") -> None:
        mix = dict(mix if mix is not None else DEFAULT_MIX)
        unknown = set(mix) - set(self.KINDS)
        if unknown:
            raise ValueError(f"unknown workload kinds: {sorted(unknown)}")
        total = sum(mix.values())
        if total <= 0:
            raise ValueError("mix weights must sum to > 0")
        self.mix = {k: v / total for k, v in mix.items() if v > 0}
        if self.mix.get("probe") and probe_edges <= 0:
            raise ValueError(
                "a probe component needs probe_edges (the served road "
                "graph's edge count) to draw valid edge ids")
        self.seed = seed
        self.batch_rows = batch_rows
        self.sse_channel = sse_channel
        self.road_graph = road_graph
        self.probe_edges = int(probe_edges)
        self.probe_obs = int(probe_obs)
        self.od = ZipfODWorkload(s=s, seed=seed)
        # Route traffic gets its OWN Zipf OD stream: bodies are
        # byte-stable per pair (``route_body_for_pair``), so a skewed
        # pair stream is exactly what exercises the route fastlane —
        # hot OD pairs repeat as identical ``request_route`` bodies,
        # mirroring the measured 0.97 predict_eta key-skew hit rate.
        # ``route_zipf_s`` decouples the route skew from the ETA skew
        # (defaults to the same exponent).
        self.route_stops = int(route_stops)
        self.route_od = ZipfODWorkload(
            s=s if route_zipf_s is None else route_zipf_s, seed=seed)
        # Dispatch traffic draws its depots from the route stream's
        # Zipf pair vocabulary (same skew: hot depots repeat as
        # byte-identical problems, which the dispatch batcher merges).
        self.dispatch_stops = int(dispatch_stops)
        # Region affinity (multi-region serving, docs/LOADGEN.md):
        # each client carries a seeded Zipf-skewed ``region`` hint — a
        # hot region takes most of the demand, the tail regions see a
        # trickle — appended as a ``?region=`` query parameter (the
        # geo-front's routing hint; single-region stacks ignore it).
        # Skew matters here for the same reason OD skew does: a
        # survivable-region-loss test is only honest when the DEAD
        # region was the hot one.
        self.regions: Tuple[str, ...] = tuple(regions or ())
        if region_zipf_s < 0:
            raise ValueError("region zipf exponent must be >= 0")
        self.region_zipf_s = float(region_zipf_s)
        # Batch-ETA transport (docs/LOADGEN.md "Wire format"): "json"
        # sends the row-shaped items body; "binary" pre-encodes the
        # SAME seeded rows into a wire frame (client-side
        # ``encode_requests`` featurization + RTW1 framing), so open-
        # loop benches measure the zero-copy path with identical
        # offered traffic. Bodies stay byte-stable per (params, seed)
        # in both modes.
        if wire_format not in ("json", "binary"):
            raise ValueError("wire_format must be 'json' or 'binary'")
        self.wire_format = wire_format

    def _region_draws(self, n: int) -> Optional[np.ndarray]:
        if not self.regions:
            return None
        rng = np.random.default_rng((self.seed, 11))
        ranks = np.arange(1, len(self.regions) + 1, dtype=np.float64)
        weights = ranks ** -self.region_zipf_s
        weights /= weights.sum()
        return rng.choice(len(self.regions), size=max(n, 1), p=weights)

    @staticmethod
    def _with_region(req: PlannedRequest, region: str) -> PlannedRequest:
        sep = "&" if "?" in req.path else "?"
        return dataclasses.replace(
            req, path=f"{req.path}{sep}region={region}")

    def _wire_batch(self, row_pair_ids: np.ndarray) -> bytes:
        """The binary twin of the items-shaped batch body: featurize
        the same Zipf rows client-side with the server's own
        ``encode_requests`` (``native/`` fastfeat, bitwise its numpy
        twin) and frame them (RTW1). Deterministic in the
        pair ids, so a (params, seed) pair maps to one exact byte
        string — same contract as the JSON bodies."""
        import datetime as _dt

        from routest_tpu_torch.data.features import encode_requests
        from routest_tpu_torch.serve.wirecodec import encode_eta_request

        bodies = [self.od.body_for_pair(int(r)) for r in row_pair_ids]
        pickups = [_dt.datetime.fromisoformat(b["pickup_time"])
                   for b in bodies]
        features = encode_requests(
            weather=[b["weather"] for b in bodies],
            traffic=[b["traffic"] for b in bodies],
            weekday=[p.weekday() for p in pickups],
            hour=[p.hour for p in pickups],
            distance_km=[b["summary"]["distance"] / 1000.0
                         for b in bodies],
            driver_age=[b["driver_age"] for b in bodies])
        pickup_ms = np.asarray(
            [np.datetime64(b["pickup_time"], "ms") for b in bodies],
            "datetime64[ms]").astype(np.int64)
        return encode_eta_request(np.asarray(features, np.float32),
                                  pickup_ms)

    def sequence(self, n: int) -> List[PlannedRequest]:
        rng = np.random.default_rng((self.seed, 2))
        kinds = list(self.mix)
        weights = np.asarray([self.mix[k] for k in kinds])
        draws = rng.choice(len(kinds), size=n, p=weights)
        pair_ids = self.od.pair_indices(max(n, 1), seed_offset=3)
        route_pair_ids = self.route_od.pair_indices(max(n, 1),
                                                    seed_offset=7)
        out: List[PlannedRequest] = []
        for idx, kind_i in enumerate(draws):
            kind = kinds[int(kind_i)]
            pair = int(pair_ids[idx])
            if kind == "predict_eta":
                out.append(PlannedRequest(
                    "POST", "/api/predict_eta",
                    self.od.body_for_pair(pair), "/api/predict_eta"))
            elif kind == "request_route":
                out.append(PlannedRequest(
                    "POST", "/api/request_route",
                    self.route_od.route_body_for_pair(
                        int(route_pair_ids[idx]), stops=self.route_stops,
                        road_graph=self.road_graph),
                    "/api/request_route"))
            elif kind == "history":
                out.append(PlannedRequest(
                    "GET", "/api/history?limit=10", None, "/api/history"))
            elif kind == "update_tracker":
                # Driver-position tick published to the SSE bus on the
                # workload's channel — what lights up the long-lived
                # ``engine.SseClients`` subscribers.
                i, j = self.od.pairs[pair]
                _, lat1, lon1 = self.od._locations[i]
                _, lat2, lon2 = self.od._locations[j]
                out.append(PlannedRequest(
                    "POST", "/api/update_tracker", {
                        "route_id": self.sse_channel,
                        "route": [[lon1, lat1], [lon2, lat2]],
                        "destinations": [{"lat": lat2, "lon": lon2}],
                        "driver_name": f"lg-{pair}",
                        "vehicle_type": "car",
                        "duration": 600, "distance": 5000, "trips": 1,
                        "pickup_time": "2026-08-04T18:00:00",
                    }, "/api/update_tracker"))
            elif kind == "dispatch":
                out.append(PlannedRequest(
                    "POST", "/api/dispatch",
                    self.route_od.dispatch_body_for_pair(
                        int(route_pair_ids[idx]),
                        stops=self.dispatch_stops),
                    "/api/dispatch"))
            elif kind == "probe":
                # Live-update traffic: one driver's per-edge speed
                # observations, POSTed to /api/probe (which publishes
                # to the probe channel — every replica's ingester folds
                # it). Bodies are seeded like everything else, so the
                # same (mix, seed) offers identical probe load.
                edges = rng.integers(0, self.probe_edges,
                                     size=self.probe_obs)
                speeds = rng.uniform(2.0, 14.0, size=self.probe_obs)
                out.append(PlannedRequest(
                    "POST", "/api/probe", {
                        "driver": f"lg-{pair % 97}",
                        "obs": [[int(e), round(float(v), 3)]
                                for e, v in zip(edges, speeds)],
                    }, "/api/probe"))
            else:  # predict_eta_batch
                rows = self.od.pair_indices(self.batch_rows,
                                            seed_offset=1000 + pair)
                if self.wire_format == "binary":
                    out.append(PlannedRequest(
                        "POST", "/api/predict_eta_batch",
                        self._wire_batch(rows),
                        "/api/predict_eta_batch",
                        content_type="application/x-rtpu-wire"))
                else:
                    out.append(PlannedRequest(
                        "POST", "/api/predict_eta_batch",
                        {"items": [self.od.body_for_pair(int(r))
                                   for r in rows]},
                        "/api/predict_eta_batch"))
        region_ids = self._region_draws(n)
        if region_ids is not None:
            out = [self._with_region(req, self.regions[int(r)])
                   for req, r in zip(out, region_ids)]
        return out

    def describe(self) -> dict:
        out = {"mix": dict(self.mix), "zipf_s": self.od.s,
               "seed": self.seed, "od_pairs": len(self.od.pairs),
               "batch_rows": self.batch_rows,
               "sse_channel": self.sse_channel,
               "road_graph": self.road_graph,
               "route_zipf_s": self.route_od.s,
               "route_stops": self.route_stops,
               "wire_format": self.wire_format}
        if self.mix.get("probe"):
            out["probe_edges"] = self.probe_edges
            out["probe_obs"] = self.probe_obs
        if self.mix.get("dispatch"):
            out["dispatch_stops"] = self.dispatch_stops
        if self.regions:
            out["regions"] = list(self.regions)
            out["region_zipf_s"] = self.region_zipf_s
        return out
