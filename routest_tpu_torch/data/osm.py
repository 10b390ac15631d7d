"""OSM-format road-network ingest → the road-graph dict schema.

The counterpart of ``routest_tpu/data/osm.py``: parse an OpenStreetMap
XML extract (``.osm``, optionally gzipped) into the flat-array schema
``RoadRouter(graph=load_osm(path))`` routes over. The JAX package's C++
scanner is not ported (it waits with ``native/`` for Queue A item 18);
this is its ElementTree path, which owns the semantics and every error
message, and which that scanner matches array for array.

Parsing model (stdlib ``xml.etree.iterparse``, element by element):

- ``<node id lat lon>`` — coordinate store;
- ``<way>`` with a ``highway`` tag in the drivable set — split into one
  edge per consecutive ``<nd>`` pair (every bend is a graph vertex,
  lengths are true haversine);
- ``oneway=yes/-1`` respected, ``junction=roundabout/circular``
  implies one-way when no explicit tag; everything else symmetrized;
- ``maxspeed`` parsed ("50", "50 km/h", "30 mph"), else the class
  default; highway class mapped onto the 3-class scheme the GNN and
  free-flow pricer share (arterial / collector / local).

Only nodes referenced by kept ways survive, re-indexed contiguously.
"""

from __future__ import annotations

import gzip
import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, IO, Tuple

import numpy as np

from routest_tpu_torch.data.road_graph import _CLASS_SPEED_MPS, haversine_np

# highway=* → road class (0 arterial, 1 collector, 2 local).
_HIGHWAY_CLASS = {
    "motorway": 0, "motorway_link": 0, "trunk": 0, "trunk_link": 0,
    "primary": 0, "primary_link": 0,
    "secondary": 1, "secondary_link": 1, "tertiary": 1, "tertiary_link": 1,
    "unclassified": 2, "residential": 2, "living_street": 2, "service": 2,
}

_MPH_TO_MPS = 0.44704
_KMH_TO_MPS = 1.0 / 3.6


def _parse_maxspeed(value: str) -> float:
    """OSM maxspeed text → m/s; raises ValueError on non-numeric forms
    (``"walk"``, ``"none"``, zone refs) so the caller falls back.

    Deliberately stricter than bare ``float()``: hex forms, digit
    underscores, and inf/nan are rejected too — they never appear in
    real OSM data (the JAX package's native scanner applies the same
    rule)."""

    def strict(text: str) -> float:
        if not text or any(c not in "0123456789.+-eE" for c in text):
            raise ValueError(f"non-numeric maxspeed: {text!r}")
        out = float(text)
        if not math.isfinite(out):
            raise ValueError(f"non-finite maxspeed: {text!r}")
        return out

    text = value.strip().lower()
    if text.endswith("mph"):
        return strict(text[:-3].strip()) * _MPH_TO_MPS
    if text.endswith("km/h"):
        text = text[:-4].strip()
    return strict(text) * _KMH_TO_MPS


def _open(path: str) -> IO[bytes]:
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def load_osm(path: str) -> Dict[str, np.ndarray]:
    """Parse an OSM XML extract into the road-graph dict schema.

    Returns the arrays ``RoadRouter`` consumes: ``node_coords`` (N, 2)
    lat/lon, ``senders``/``receivers``/``length_m``/``road_class``/
    ``speed_limit`` (E,). Raises ValueError for malformed XML or an
    extract with no drivable ways.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)

    coords: Dict[int, Tuple[float, float]] = {}
    # per edge: (from_osm_id, to_osm_id, road_class, speed, both_ways)
    segments = []

    way_nodes = []
    way_tags: Dict[str, str] = {}
    root = None
    try:
        with _open(path) as f:
            for event, elem in ET.iterparse(f, events=("start", "end")):
                if event == "start":
                    if root is None:
                        root = elem  # the <osm> element accumulates children
                    if elem.tag == "way":
                        way_nodes = []
                        way_tags = {}
                    continue
                if elem.tag == "node":
                    try:
                        coords[int(elem.get("id"))] = (
                            float(elem.get("lat")), float(elem.get("lon")))
                    except (TypeError, ValueError):
                        pass  # nodes without coordinates cannot carry edges
                elif elem.tag == "nd":
                    ref = elem.get("ref")
                    if ref is not None:
                        way_nodes.append(int(ref))
                elif elem.tag == "tag":
                    k, v = elem.get("k"), elem.get("v")
                    if k is not None and v is not None:
                        way_tags[k] = v
                elif elem.tag == "way":
                    _ingest_way(way_nodes, way_tags, segments)
                # elem.clear() alone is NOT enough: the root keeps an
                # (emptied) child per element, linear in file size. Drop
                # completed top-level children from the root itself so a
                # metro extract streams in O(1) element memory.
                if root is not None and elem is not root:
                    elem.clear()
                    if len(root) and root[-1] is elem:
                        del root[-1]
    except ET.ParseError as e:
        raise ValueError(f"{path}: malformed OSM XML: {e}") from None

    if not segments:
        raise ValueError(f"{path}: no drivable highway ways found")

    # Compact referenced nodes → contiguous indices.
    used = sorted({n for s in segments for n in s[:2] if n in coords})
    index = {osm_id: i for i, osm_id in enumerate(used)}
    node_coords = np.asarray([coords[i] for i in used], np.float32)

    senders, receivers, road_class, speed = [], [], [], []
    for a, b, cls, spd, both in segments:
        if a not in index or b not in index or a == b:
            continue  # refs outside the extract boundary
        senders.append(index[a])
        receivers.append(index[b])
        road_class.append(cls)
        speed.append(spd)
        if both:
            senders.append(index[b])
            receivers.append(index[a])
            road_class.append(cls)
            speed.append(spd)

    if not senders:
        raise ValueError(f"{path}: drivable ways reference no in-extract nodes")

    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    length_m = haversine_np(
        node_coords[senders, 0], node_coords[senders, 1],
        node_coords[receivers, 0], node_coords[receivers, 1],
    ).astype(np.float32)
    return {
        "node_coords": node_coords,
        "senders": senders,
        "receivers": receivers,
        "length_m": length_m,
        "road_class": np.asarray(road_class, np.int32),
        "speed_limit": np.asarray(speed, np.float32),
    }


# road class → representative highway tag (inverse of _HIGHWAY_CLASS for
# the writer; load_osm maps these back to the same class).
_CLASS_HIGHWAY = {0: "primary", 1: "secondary", 2: "residential"}


def save_osm(path: str, graph: Dict[str, np.ndarray]) -> None:
    """Inverse of :func:`load_osm`: write a road-graph dict as an OSM XML
    extract (gzipped when ``path`` ends in ``.gz``).

    Every directed edge becomes a two-node ``oneway`` way carrying its
    class (highway tag) and speed (maxspeed, km/h), so topology, classes
    and speed limits round-trip exactly. Lengths do NOT: ``load_osm``
    recomputes pure haversine from coordinates, while generated graphs
    carry a street-detour factor in ``length_m`` — a property of their
    lengths, not their geometry. Used to exercise the real-extract
    ingest path at metro scale without shipping a real (licensed) city
    extract.
    """
    coords = np.asarray(graph["node_coords"], np.float64)
    senders = np.asarray(graph["senders"])
    receivers = np.asarray(graph["receivers"])
    road_class = np.asarray(graph["road_class"])
    speed = np.asarray(graph["speed_limit"], np.float64)

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt", encoding="utf-8") as f:
        f.write('<?xml version="1.0" encoding="UTF-8"?>\n')
        f.write('<osm version="0.6" generator="routest_tpu.data.osm">\n')
        for i, (lat, lon) in enumerate(coords):
            f.write(f'  <node id="{i + 1}" lat="{lat:.7f}" '
                    f'lon="{lon:.7f}"/>\n')
        for e in range(len(senders)):
            highway = _CLASS_HIGHWAY[int(road_class[e])]
            kmh = speed[e] * 3.6
            f.write(
                f'  <way id="{len(coords) + e + 1}">\n'
                f'    <nd ref="{int(senders[e]) + 1}"/>\n'
                f'    <nd ref="{int(receivers[e]) + 1}"/>\n'
                f'    <tag k="highway" v="{highway}"/>\n'
                f'    <tag k="maxspeed" v="{kmh:.8g}"/>\n'
                f'    <tag k="oneway" v="yes"/>\n'
                f'  </way>\n')
        f.write("</osm>\n")


def _ingest_way(way_nodes, way_tags, segments) -> None:
    highway = way_tags.get("highway")
    cls = _HIGHWAY_CLASS.get(highway) if highway else None
    if cls is None or len(way_nodes) < 2:
        return
    speed = float(_CLASS_SPEED_MPS[cls])
    if "maxspeed" in way_tags:
        try:
            speed = _parse_maxspeed(way_tags["maxspeed"])
        except ValueError:
            pass  # non-numeric maxspeed: keep the class default
    oneway_tag = way_tags.get("oneway")
    if oneway_tag is None and way_tags.get("junction", "").lower() in (
            "roundabout", "circular"):
        # OSM semantics: junction=roundabout implies oneway=yes in
        # drawing order unless an explicit oneway tag overrides it.
        oneway_tag = "yes"
    oneway = (oneway_tag or "no").lower()
    pairs = zip(way_nodes[:-1], way_nodes[1:])
    if oneway == "-1":  # rare: oneway against drawing direction
        pairs = zip(way_nodes[1:], way_nodes[:-1])
    both = oneway not in ("yes", "true", "1", "-1")
    for a, b in pairs:
        segments.append((a, b, cls, speed, both))
