"""Port parity: ``routest_tpu_torch.data.features`` against the JAX
package's encoder — host outputs must match bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from routest_tpu.data import features as jf
from routest_tpu.serve.ml_service import golden_batch as jax_golden_batch
from routest_tpu_torch.data import features as tf
from routest_tpu_torch.serve.ml_service import golden_batch


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_constants_match():
    for name in ("WEATHER_CATEGORIES", "TRAFFIC_CATEGORIES", "FEATURE_NAMES",
                 "N_FEATURES", "DEFAULT_WEATHER", "DEFAULT_TRAFFIC",
                 "DEFAULT_DRIVER_AGE"):
        assert getattr(tf, name) == getattr(jf, name), name


def test_golden_batch_bitwise():
    assert _same_bits(golden_batch(), jax_golden_batch())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_rows_with_unknown_categories_bitwise(seed):
    rng = np.random.default_rng(seed)
    n = 257
    weather = list(rng.choice(list(jf.WEATHER_CATEGORIES) + ["Fog", ""], n))
    traffic = list(rng.choice(list(jf.TRAFFIC_CATEGORIES) + ["Gridlock"], n))
    kw = dict(weather=weather, traffic=traffic,
              weekday=rng.integers(0, 7, n).tolist(),
              hour=rng.integers(0, 24, n).tolist(),
              distance_km=rng.uniform(-3.0, 80.0, n).tolist(),
              driver_age=rng.uniform(18.0, 75.0, n).tolist())
    got = tf.encode_requests(**kw)
    assert _same_bits(got, jf.encode_requests(**kw))
    unknown = np.isin(weather, ["Fog", ""])
    assert (got[unknown, 0:4] == 0).all()   # unknown → all-zero group


def test_vocab_index_unknown_is_minus_one():
    values = ["Sunny", "Fog", "Cloudy", "windy"]
    assert _same_bits(tf.vocab_index(values, tf.WEATHER_CATEGORIES),
                      jf.vocab_index(values, jf.WEATHER_CATEGORIES))
    assert tf.vocab_index(values, tf.WEATHER_CATEGORIES).tolist() == \
        [2, -1, 0, -1]


@pytest.mark.parametrize("kw", [
    {},
    {"weather": "Stormy", "traffic": "Jam", "distance_m": 12_345.0,
     "weekday": 4, "hour": 17, "driver_age": 52.0},
    {"weather": None, "traffic": "Fog", "distance_m": None, "driver_age": None},
])
def test_encode_request_defaults_bitwise(kw):
    assert _same_bits(tf.encode_request(**kw), jf.encode_request(**kw))


def test_batch_from_mapping_bitwise():
    rng = np.random.default_rng(7)
    n = 300
    batch = {"weather_idx": rng.integers(-1, 4, n).astype(np.int32),
             "traffic_idx": rng.integers(-1, 4, n).astype(np.int32),
             "weekday": rng.integers(0, 7, n), "hour": rng.integers(0, 24, n),
             "distance_km": rng.uniform(0, 50, n).astype(np.float32),
             "driver_age": rng.uniform(18, 70, n).astype(np.float32)}
    assert _same_bits(tf.batch_from_mapping(batch),
                      jf.batch_from_mapping(batch))


def test_encode_features_torch_op_matches_jnp():
    rng = np.random.default_rng(3)
    n = 64
    cols = (rng.integers(-1, 4, n).astype(np.int32),
            rng.integers(-1, 4, n).astype(np.int32),
            rng.integers(0, 7, n).astype(np.int32),
            rng.integers(0, 24, n).astype(np.int32),
            rng.uniform(0, 40, n).astype(np.float32),
            rng.uniform(18, 70, n).astype(np.float32))
    want = np.asarray(jf.encode_features(*(jnp.asarray(c) for c in cols)))
    got = tf.encode_features(*(torch.from_numpy(c) for c in cols)).numpy()
    assert _same_bits(got, want)
