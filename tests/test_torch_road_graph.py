"""The port's road-graph generator (``data/road_graph.py``) and OSM
ingest (``data/osm.py``) against the JAX package's: every array bitwise
equal (values and dtypes), and the same error texts."""

import gzip
import os

import numpy as np
import pytest

from routest_tpu.data import osm as josm
from routest_tpu.data import road_graph as jrg
from routest_tpu_torch.data import osm as tosm
from routest_tpu_torch.data import road_graph as trg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRACTS = ("artifacts/manila_arterials.osm.gz", "artifacts/metro_8192.osm.gz",
            "tests/fixtures/mandaluyong_sample.osm")


def _bitwise(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert g.tobytes() == w.tobytes(), key


@pytest.mark.parametrize("n_nodes,seed", [(256, 1), (2048, 0), (96, 2)])
def test_generate_road_graph_bitwise(n_nodes, seed):
    _bitwise(trg.generate_road_graph(n_nodes=n_nodes, seed=seed),
             jrg.generate_road_graph(n_nodes=n_nodes, seed=seed))


def test_knn_cell_search_bitwise():
    """Above 8192 nodes the kNN switches to its cell-hashed search."""
    coords = np.random.default_rng(3).uniform(0, 1, (9000, 2)).astype(
        np.float32)
    assert (trg.knn_neighbors(coords, 4).tobytes()
            == jrg.knn_neighbors(coords, 4).tobytes())


def test_graph_helpers_bitwise():
    base = jrg.generate_road_graph(n_nodes=128, seed=4)
    for kw in ({}, {"bends_per_edge": 3, "oneway_frac": 0.3, "seed": 7}):
        _bitwise(trg.subdivide_graph(base, **kw),
                 jrg.subdivide_graph(base, **kw))
    for kw in ({}, {"samples_per_edge": 3, "seed": 2}):
        _bitwise(trg.add_congestion_observations(base, **kw),
                 jrg.add_congestion_observations(base, **kw))
    rng = np.random.default_rng(0)
    length = rng.uniform(5, 900, 64).astype(np.float32)
    cls = rng.integers(0, 3, 64)
    hour = rng.integers(0, 24, 64)
    assert (trg.true_edge_time_s(length, cls, hour).tobytes()
            == jrg.true_edge_time_s(length, cls, hour).tobytes())
    a = rng.uniform(14.4, 14.7, (4, 50))
    assert (trg.haversine_np(*a).tobytes() == jrg.haversine_np(*a).tobytes())
    assert trg._CLASS_SPEED_MPS.tobytes() == jrg._CLASS_SPEED_MPS.tobytes()


@pytest.mark.parametrize("path", EXTRACTS)
def test_load_osm_bitwise(path):
    path = os.path.join(REPO, path)
    _bitwise(tosm.load_osm(path), josm.load_osm(path))


@pytest.mark.parametrize("text", ["50", " 50 km/h", "30 mph", "1e1", "walk",
                                  "none", "0x10", "1_0", "inf", "nan", "",
                                  "-5 mph"])
def test_parse_maxspeed_matches(text):
    def run(fn):
        try:
            return fn(text)
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(tosm._parse_maxspeed) == run(josm._parse_maxspeed)


def test_save_osm_writes_the_same_extract(tmp_path):
    graph = jrg.generate_road_graph(n_nodes=64, seed=5)
    tosm.save_osm(str(tmp_path / "t.osm.gz"), graph)
    josm.save_osm(str(tmp_path / "j.osm.gz"), graph)
    with gzip.open(tmp_path / "t.osm.gz") as t, \
            gzip.open(tmp_path / "j.osm.gz") as j:
        assert t.read() == j.read()
    _bitwise(tosm.load_osm(str(tmp_path / "t.osm.gz")),
             josm.load_osm(str(tmp_path / "j.osm.gz")))


@pytest.mark.parametrize("text", [
    "<osm><node id='1'",
    "<osm><node id='1' lat='14.5' lon='121.0'/></osm>",
    "<osm><node id='1' lat='14.5' lon='121.0'/><way id='2'><nd ref='1'/>"
    "<nd ref='9'/><tag k='highway' v='primary'/></way></osm>",
])
def test_load_osm_errors_match(tmp_path, text):
    path = tmp_path / "bad.osm"
    path.write_text(text)
    with pytest.raises(ValueError) as want:
        josm.load_osm(str(path))
    with pytest.raises(ValueError) as got:
        tosm.load_osm(str(path))
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        tosm.load_osm(str(tmp_path / "missing.osm"))
