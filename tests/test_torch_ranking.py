"""The port's counter-based generator (``core/prng.py``) and candidate
ranking (``optimize/ranking.py``) against ``jax.random`` and the JAX
package's ``optimize/ranking.py``, the port on the CPU.

Bitwise: PRNG keys, splits and uniform bits; perturbed-greedy candidate
orders at 10 stops; deduplicated candidate sets; path distances (legs
summed in XLA's order); ranked orders. Both sides rank over the same
float32 matrix (the JAX package's). The one exception to bitwise
equality is the model-scored branch: its ETAs are held at the f32 class
(rtol 1e-4 / atol 1e-3), and its orders up to a closed tour's direction
(reversal twins tie to within one ulp; see the test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from routest_tpu.core.dtypes import F32_POLICY as J_F32
from routest_tpu.data import geo as jgeo
from routest_tpu.data.locations import coords_array
from routest_tpu.models.eta_mlp import EtaMLP as JEtaMLP
from routest_tpu.optimize import ranking as jrank
from routest_tpu_torch.core import prng
from routest_tpu_torch.core.dtypes import F32_POLICY
from routest_tpu_torch.models.eta_mlp import EtaMLP
from routest_tpu_torch.optimize import ranking as trank


def _manila_dist(rng, n_stops):
    """A JAX haversine matrix over ``n_stops + 1`` distinct seed sites."""
    idx = rng.choice(21, n_stops + 1, replace=False)
    return np.asarray(jgeo.distance_matrix_m(
        jnp.asarray(coords_array()[idx]), 1.42))


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 7, -1, 2**31 - 1, 123456789])
def test_prng_key_split_uniform_bitwise(seed):
    jkey = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey, np.int64))
    jkeys = jax.random.split(jkey, 1536)
    tkeys = prng.split(tkey, 1536)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys, np.int64))
    ju = jax.vmap(lambda k: jax.random.uniform(k, (11, 11)))(jkeys)
    tu = prng.uniform(tkeys, (11, 11))
    assert _bits(ju).tobytes() == tu.numpy().view(np.uint32).tobytes()
    for shape in ((), (5,), (3, 7), (2, 3, 4)):
        assert (_bits(jax.random.uniform(jkey, shape)).tobytes()
                == prng.uniform(tkey, shape).numpy().view(np.uint32)
                .tobytes()), shape


@pytest.mark.parametrize("trial", range(3))
def test_perturbed_greedy_orders_bitwise_at_10_stops(trial):
    """The engine's draw: 1536 candidates (2048 minus the uniform tail)."""
    dist = _manila_dist(np.random.default_rng(trial), 10)
    want = jrank.perturbed_greedy_orders(dist, 1536, seed=0)
    got = trank.perturbed_greedy_orders(dist, 1536, seed=0, device="cpu")
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_perturbed_greedy_other_seeds_and_sizes():
    rng = np.random.default_rng(3)
    for n, k, seed in ((4, 1, 0), (12, 300, 42)):
        pts = rng.uniform(0, 10, size=(n + 1, 2))
        dist = np.linalg.norm(pts[:, None] - pts[None, :],
                              axis=-1).astype(np.float32)
        np.testing.assert_array_equal(
            trank.perturbed_greedy_orders(dist, k, seed=seed, device="cpu"),
            jrank.perturbed_greedy_orders(dist, k, seed=seed))


@pytest.mark.parametrize("n,budget,greedy", [(4, 4096, False),
                                             (8, 64, True), (10, 2048, True),
                                             (10, 2048, False)])
def test_candidate_permutations_equal(n, budget, greedy):
    dist = _manila_dist(np.random.default_rng(n), n)
    order = np.arange(n, dtype=np.int32)[::-1] if greedy else None
    np.testing.assert_array_equal(
        trank.candidate_permutations(n, budget, greedy_order=order,
                                     dist=dist, device="cpu"),
        jrank.candidate_permutations(n, budget, greedy_order=order,
                                     dist=dist))


def test_candidate_permutations_without_matrix_equal():
    np.testing.assert_array_equal(
        trank.candidate_permutations(9, 300, seed=5),
        jrank.candidate_permutations(9, 300, seed=5))


def test_path_distances_bitwise():
    rng = np.random.default_rng(4)
    dist = _manila_dist(rng, 10)
    perms = np.stack([rng.permutation(10) for _ in range(700)]).astype(
        np.int32)
    for back in (True, False):
        want = np.asarray(jrank.path_distances(jnp.asarray(dist),
                                               jnp.asarray(perms), back))
        got = trank.path_distances(torch.tensor(dist), torch.tensor(perms),
                                   back).numpy()
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n,k", [(5, 10), (10, 22)])
def test_rank_routes_orders_equal(n, k):
    """Distance-scored ranking as the engine calls it: reversal twins tie
    exactly, and the lower candidate index wins, as with lax.top_k."""
    dist = _manila_dist(np.random.default_rng(10 + n), n)
    greedy = jrank.perturbed_greedy_orders(dist, 1)[0]
    want = jrank.rank_routes(dist, k=k, speed_mps=8.3, max_candidates=2048,
                             greedy_order=greedy)
    got = trank.rank_routes(dist, k=k, speed_mps=8.3, max_candidates=2048,
                            greedy_order=greedy, device="cpu")
    np.testing.assert_array_equal(got.orders, want.orders)
    assert got.distances_m.tobytes() == want.distances_m.tobytes()
    assert np.isnan(got.etas_min).all() and np.isnan(want.etas_min).all()


def test_rank_routes_model_scored():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 10, size=(6, 2))
    dist = (np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
            * 1000.0).astype(np.float32)
    jmodel = JEtaMLP(hidden=(16,), policy=J_F32)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = EtaMLP.from_numpy(jax.tree_util.tree_map(np.asarray, params),
                               hidden=(16,), policy=F32_POLICY)
    ctx = {"weekday": 2, "hour": 9}
    want = jrank.rank_routes(dist, k=6, model=jmodel, params=params,
                             context=ctx)
    got = trank.rank_routes(dist, k=6, model=tmodel, context=ctx,
                            device="cpu")
    # Named exception: a tour and its reversal have path distances one
    # float32 ulp apart (31588.28 vs 31588.281 m for candidates 99 and 38
    # here); the JAX model rounds both to 4.9717536 min (a tie, so index
    # 38 ranks first), the port's to 4.971752 / 4.9717526 (99 first).
    # Orders are held equal up to a closed tour's direction.
    def tours(orders):
        return [min(tuple(o), tuple(o[::-1])) for o in orders.tolist()]

    assert tours(got.orders) == tours(want.orders)
    np.testing.assert_allclose(got.etas_min, want.etas_min, rtol=1e-4,
                               atol=1e-3)
    assert (np.diff(got.etas_min) >= -1e-4).all()


def test_ranking_on_a_missing_card_raises(monkeypatch):
    monkeypatch.delenv("ROUTEST_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trank.rank_routes(np.zeros((3, 3), np.float32))
