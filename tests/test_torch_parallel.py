"""The port's parallel layer (``routest_tpu_torch/parallel/``) against the
JAX package's (``routest_tpu/parallel/``) on the same inputs.

Every case of ``tests/test_parallel.py``, ``test_tensor_parallel.py``,
``test_pipeline.py`` and ``test_expert.py`` runs here with the same
numpy inputs through the JAX function on its virtual-device mesh and
the port's function on a mesh of 2, 4 or 8 CPU shards
(``[torch.device("cpu")] * n``), held to the JAX test's tolerance:

- ring and Ulysses attention against ``full_attention`` and the JAX
  sharded programs: forward 1e-5, gradients 1e-4; blockwise attention
  likewise; a fully masked row is 0;
- tensor parallelism: forward and loss 1e-5, gradients and one SGD
  step 2e-4; the port's AdamW trains under the layout;
- the pipeline against ``sequential_apply`` and the JAX pipeline:
  forward 1e-5, per-stage gradients rtol 1e-4 / atol 1e-5;
- expert parallelism against ``moe_apply_dense`` and the JAX layer
  (rtol 1e-4 / atol 1e-5); which tokens drop and the dropped fraction
  are bitwise the JAX layer's; ``init_moe_params`` within 4 ulp of the
  JAX draw (the normal draw's ``erf_inv``, as ``tests/test_torch_train.py``
  holds ``EtaMLP.init``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as JP

from routest_tpu.core.config import MeshConfig as JMeshConfig
from routest_tpu.core.dtypes import F32_POLICY as JF32
from routest_tpu.core.mesh import MeshRuntime as JMeshRuntime
from routest_tpu.data.features import batch_from_mapping
from routest_tpu.data.synthetic import generate_dataset
from routest_tpu.models.eta_mlp import EtaMLP as JEtaMLP
from routest_tpu.parallel import expert as jex
from routest_tpu.parallel import pipeline as jpp
from routest_tpu.parallel import ring as jring
from routest_tpu.parallel import tensor as jtp
from routest_tpu.parallel import ulysses as julysses
from routest_tpu_torch.core import prng
from routest_tpu_torch.core.config import MeshConfig
from routest_tpu_torch.core.dtypes import F32_POLICY
from routest_tpu_torch.core.mesh import Mesh, MeshRuntime
from routest_tpu_torch.core.smap import tree_leaves
from routest_tpu_torch.models.eta_mlp import EtaMLP
from routest_tpu_torch.parallel import expert as tex
from routest_tpu_torch.parallel import pipeline as tpp
from routest_tpu_torch.parallel import ring as tring
from routest_tpu_torch.parallel import tensor as ttp
from routest_tpu_torch.parallel import ulysses as tulysses
from routest_tpu_torch.train.loop import AdamW

B, S, H, D = 2, 64, 8, 16
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Shard threads run torch ops side by side: one intra-op thread
    each keeps them from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_mesh(n, names=("seq",)):
    grid = np.empty(n, dtype=object)
    grid[:] = [CPU] * n
    return Mesh(grid, names)


def _jax_mesh(n, names=("seq",)):
    return JMesh(np.asarray(jax.devices()[:n]), names)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _n(t):
    return t.detach().numpy()


class _SGD:
    """optax's ``sgd`` with the port optimizer's interface: the update
    is linear in the gradient, so f32 gradient noise stays f32 noise in
    the parameters (adam's first step is sign-like)."""

    def __init__(self, params, lr):
        self.params, self.lr = list(params), lr

    @torch.no_grad()
    def step(self, grads):
        for p, g in zip(self.params, grads):
            p.sub_(self.lr * g)


# ── ring / Ulysses (tests/test_parallel.py) ──────────────────────────


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, H, D)).astype(np.float32)
                 for _ in range(3))


SP = {"ring": (jring.ring_attention_sharded, tring.ring_attention_sharded),
      "ulysses": (julysses.ulysses_attention_sharded,
                  tulysses.ulysses_attention_sharded)}


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_full(n_dev, causal):
    q, k, v = _qkv(0)
    want = np.asarray(jring.full_attention(q, k, v, causal=causal))
    jgot = np.asarray(jring.ring_attention_sharded(
        q, k, v, _jax_mesh(n_dev), causal=causal))
    got = _n(tring.ring_attention_sharded(*map(_t, (q, k, v)),
                                          _port_mesh(n_dev), causal=causal))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_full(n_dev, causal):
    q, k, v = _qkv(1)
    want = np.asarray(jring.full_attention(q, k, v, causal=causal))
    jgot = np.asarray(julysses.ulysses_attention_sharded(
        q, k, v, _jax_mesh(n_dev), causal=causal))
    got = _n(tulysses.ulysses_attention_sharded(
        *map(_t, (q, k, v)), _port_mesh(n_dev), causal=causal))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_key_padding_mask(impl):
    q, k, v = _qkv(2)
    mask = np.ones((B, S), np.float32)
    mask[0, S // 2:] = 0.0   # route 0 is half padding
    want = np.asarray(jring.full_attention(q, k, v, key_mask=mask))
    jfn, tfn = SP[impl]
    jgot = np.asarray(jfn(q, k, v, _jax_mesh(4), key_mask=jnp.asarray(mask)))
    got = _n(tfn(*map(_t, (q, k, v)), _port_mesh(4), key_mask=_t(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)
    # padded keys carry zero weight: perturbing them changes nothing
    v2 = v.copy()
    v2[0, S // 2:] += 100.0
    got2 = _n(tfn(*map(_t, (q, k, v2)), _port_mesh(4), key_mask=_t(mask)))
    np.testing.assert_allclose(got2[0, : S // 2], got[0, : S // 2],
                               rtol=1e-4, atol=1e-4)


def test_fully_masked_rows_are_zero():
    q, k, v = _qkv(3)
    mask = np.zeros((B, S), np.float32)
    jgot = np.asarray(jring.ring_attention_sharded(
        q, k, v, _jax_mesh(4), key_mask=jnp.asarray(mask)))
    out = _n(tring.ring_attention_sharded(*map(_t, (q, k, v)),
                                          _port_mesh(4), key_mask=_t(mask)))
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, 0.0, atol=1e-6)
    np.testing.assert_array_equal(out, jgot)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gradients_match_full_attention(impl):
    q, k, v = _qkv(4)
    jfn, tfn = SP[impl]
    jmesh, tmesh = _jax_mesh(4), _port_mesh(4)
    jgrads = jax.grad(lambda q, k, v: (jfn(q, k, v, jmesh) ** 2).sum(),
                      argnums=(0, 1, 2))(q, k, v)
    full = jax.grad(lambda q, k, v: (jring.full_attention(q, k, v) ** 2)
                    .sum(), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    loss = (tfn(tq, tk, tv, tmesh) ** 2).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for g, jg, fg in zip(got, jgrads, full):
        np.testing.assert_allclose(_n(g), np.asarray(fg), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(_n(g), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("chunk", [16, 24, 64, 100])
def test_blockwise_matches_full(causal, chunk):
    # chunks that divide S, exceed it (early-out) and straddle it
    q, k, v = _qkv(3)
    mask = np.ones((B, S), np.float32)
    mask[0, 40:] = 0.0
    mask[1, :] = 0.0  # one row fully masked: output must be zeros
    want = np.asarray(jring.blockwise_attention(
        q, k, v, key_mask=jnp.asarray(mask), causal=causal, chunk=chunk))
    full = np.asarray(jring.full_attention(q, k, v, key_mask=mask,
                                           causal=causal))
    got = _n(tring.blockwise_attention(*map(_t, (q, k, v)),
                                       key_mask=_t(mask), causal=causal,
                                       chunk=chunk))
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jring.full_attention(q, k, v, causal=causal))
    got = _n(tring.blockwise_attention(*map(_t, (q, k, v)), causal=causal,
                                       chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [16, 24])
def test_blockwise_gradients_match_full(chunk):
    q, k, v = _qkv(4)
    mask = np.r_[np.ones((1, S)),
                 np.r_[np.ones(S // 2), np.zeros(S // 2)][None]
                 ].astype(np.float32)
    want_val, want = jax.value_and_grad(
        lambda q, k, v: (jring.full_attention(q, k, v, key_mask=mask) ** 2)
        .sum(), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    val = (tring.blockwise_attention(tq, tk, tv, key_mask=_t(mask),
                                     chunk=chunk) ** 2).sum()
    got = torch.autograd.grad(val, (tq, tk, tv))
    np.testing.assert_allclose(float(val.detach()), float(want_val),
                               rtol=1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_n(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# ── tensor parallelism (tests/test_tensor_parallel.py) ───────────────


@pytest.fixture(scope="module")
def tp_rows():
    return batch_from_mapping(generate_dataset(64, seed=3))


def _tp_pair(data, model_par, hidden=(64, 64), seed=0):
    jrt = JMeshRuntime.create(JMeshConfig(data=data, model=model_par))
    rt = MeshRuntime.create(MeshConfig(data=data, model=model_par),
                            devices=[CPU] * 8)
    jm = JEtaMLP(hidden=hidden, policy=JF32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm = EtaMLP(hidden=hidden, policy=F32_POLICY)
    return jrt, rt, jm, tm, params


@pytest.mark.parametrize("data,model_par", [(4, 2), (2, 4)])
def test_tp_forward_matches_dense(data, model_par, tp_rows):
    jrt, rt, jm, tm, params = _tp_pair(data, model_par)
    want = np.asarray(jm.apply(params, tp_rows))
    jgot = np.asarray(jtp.make_tp_apply(jm, jrt.mesh)(
        jtp.shard_tp_params(params, jm, jrt.mesh), jnp.asarray(tp_rows)))
    got = _n(ttp.make_tp_apply(tm, rt.mesh)(
        ttp.shard_tp_params(params, tm, rt.mesh), _t(tp_rows)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)


def test_tp_odd_layer_count_replicates_head(tp_rows):
    # col, row, then the 2-wide head replicated
    jrt, rt, jm, tm, params = _tp_pair(4, 2, hidden=(64, 32), seed=1)
    assert ttp._layer_modes(3) == jtp._layer_modes(3) == ["col", "row",
                                                          "rep"]
    want = np.asarray(jm.apply(params, tp_rows))
    got = _n(ttp.make_tp_apply(tm, rt.mesh)(
        ttp.shard_tp_params(params, tm, rt.mesh), _t(tp_rows)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tp_gradients_match_dense(tp_rows):
    jrt, rt, jm, tm, params = _tp_pair(4, 2)
    y = np.linspace(5.0, 60.0, len(tp_rows)).astype(np.float32)
    want = jax.grad(lambda p: jnp.mean((jm.apply(p, tp_rows) - y) ** 2))(
        params)
    jloss = jtp.make_tp_loss(jm, jrt.mesh)
    jgot = jax.grad(lambda p: jloss(p, tp_rows, y))(
        jtp.shard_tp_params(params, jm, jrt.mesh))
    sharded = ttp.shard_tp_params(params, tm, rt.mesh)
    loss = ttp.make_tp_loss(tm, rt.mesh)(sharded, _t(tp_rows), _t(y))
    leaves, _ = ttp.tp_trainable(sharded)
    got = torch.autograd.grad(loss, leaves)
    dense = EtaMLP.from_numpy(params, hidden=(64, 64), policy=F32_POLICY)
    dense_loss = torch.mean((dense(_t(tp_rows)) - _t(y)) ** 2)
    port_dense = torch.autograd.grad(
        dense_loss, [t for lin in dense.layers for t in (lin.bias,
                                                         lin.weight)])
    # across packages the f32 sums run in other orders: the port's
    # one-step gradient class (tests/test_torch_train.py) adds 1e-6 of
    # the global gradient norm to the atol
    norm = float(np.sqrt(sum((np.asarray(g) ** 2).sum()
                             for g in jax.tree_util.tree_leaves(want))))
    for i, layer in enumerate(params["layers"]):
        for j, name in enumerate(("b", "w")):
            g = _n(got[2 * i + j])
            pd = _n(port_dense[2 * i + j])
            np.testing.assert_allclose(g, pd.T if name == "w" else pd,
                                       rtol=2e-4, atol=2e-4)
            for ref in (want, jgot):
                np.testing.assert_allclose(
                    g, np.asarray(ref["layers"][i][name]), rtol=2e-4,
                    atol=2e-4 + 1e-6 * norm)


def test_tp_four_layer_default_shape_parity():
    # the default trunk (256, 256, 128) ends row-parallel: col/row/col/row
    rows = batch_from_mapping(generate_dataset(32, seed=9))
    jrt = JMeshRuntime.create(JMeshConfig(data=4, model=2))
    rt = MeshRuntime.create(MeshConfig(data=4, model=2), devices=[CPU] * 8)
    jm = JEtaMLP(policy=JF32)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(2)))
    tm = EtaMLP(policy=F32_POLICY)
    want = np.asarray(jm.apply(params, rows))
    jgot = np.asarray(jtp.make_tp_apply(jm, jrt.mesh)(
        jtp.shard_tp_params(params, jm, jrt.mesh), jnp.asarray(rows)))
    got = _n(ttp.make_tp_apply(tm, rt.mesh)(
        ttp.shard_tp_params(params, tm, rt.mesh), _t(rows)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)


def test_tp_rejects_indivisible_widths():
    jrt = JMeshRuntime.create(JMeshConfig(data=2, model=4))
    rt = MeshRuntime.create(MeshConfig(data=2, model=4), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="divisible") as jerr:
        jtp.make_tp_apply(JEtaMLP(hidden=(30, 64), policy=JF32), jrt.mesh)
    with pytest.raises(ValueError, match="divisible") as terr:
        ttp.make_tp_apply(EtaMLP(hidden=(30, 64), policy=F32_POLICY),
                          rt.mesh)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("data,model_par", [(4, 2), (2, 4)])
def test_tp_train_step_matches_dense_training(data, model_par, tp_rows):
    """One TP step under the layout = the dense step: same loss, same
    gradients through the collectives, same (linear) update."""
    jrt, rt, jm, tm, params = _tp_pair(data, model_par)
    y = np.linspace(5.0, 60.0, len(tp_rows)).astype(np.float32)
    opt = optax.sgd(1e-3)
    d_loss, d_grads = jax.value_and_grad(
        lambda p: jnp.mean((jm.apply(p, tp_rows) - y) ** 2))(params)
    want = optax.apply_updates(
        params, opt.update(d_grads, opt.init(params), params)[0])
    sharded = ttp.shard_tp_params(params, tm, rt.mesh)
    step = ttp.make_tp_train_step(
        tm, _SGD(ttp.tp_trainable(sharded)[0], 1e-3), rt.mesh)
    new, loss = step(sharded, _t(tp_rows), _t(y))
    np.testing.assert_allclose(float(loss), float(d_loss), rtol=1e-5)
    got = ttp.tp_params_to_numpy(new)
    for i, layer in enumerate(want["layers"]):
        for name in ("b", "w"):
            np.testing.assert_allclose(got["layers"][i][name],
                                       np.asarray(layer[name]),
                                       rtol=2e-4, atol=2e-4)


def test_tp_train_step_preserves_layout_and_learns(tp_rows):
    _, rt, jm, tm, params = _tp_pair(4, 2)
    y = np.linspace(5.0, 60.0, len(tp_rows)).astype(np.float32)
    sharded = ttp.shard_tp_params(params, tm, rt.mesh)
    leaves, decay = ttp.tp_trainable(sharded)
    step = ttp.make_tp_train_step(
        tm, AdamW(leaves, 1e-2, 0.0, decay=decay), rt.mesh)
    losses = []
    for _ in range(25):
        sharded, loss = step(sharded, _t(tp_rows), _t(y))
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0], losses[::8]
    # the optimizer stepped the layout's own leaves in place
    assert ttp.tp_trainable(sharded)[0] == leaves
    assert [tuple(layer["w"].shape) for layer in sharded["layers"]] \
        == [tuple(np.shape(layer["w"])) for layer in params["layers"]]


def test_tp_specs_cover_every_param():
    jm = JEtaMLP(hidden=(64, 64, 32), policy=JF32)
    tm = EtaMLP(hidden=(64, 64, 32), policy=F32_POLICY)
    jspecs = jtp.tp_param_specs(jm)
    specs = ttp.tp_param_specs(tm)
    assert len(specs["layers"]) == len(jspecs["layers"]) == 4
    for got, want in zip(specs["layers"], jspecs["layers"]):
        assert {k: tuple(v) for k, v in got.items()} \
            == {k: tuple(v) for k, v in want.items()}
    # the module's own weights carry over to the same tree
    params = ttp.tp_params_from_module(tm)
    assert len(tree_leaves(params)) == len(
        jax.tree_util.tree_leaves(jm.init(jax.random.PRNGKey(0))))


# ── pipeline (tests/test_pipeline.py) ────────────────────────────────


def _jstage(p, x):
    return jax.nn.gelu(x @ p["w"] + p["b"])


def _tstage(p, x):
    return torch.nn.functional.gelu(x @ p["w"] + p["b"], approximate="tanh")


def _stages(n_stages, d, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
             "b": np.zeros(d, np.float32)} for _ in range(n_stages)]


@pytest.mark.parametrize("n_stages,n_micro", [(4, 8), (8, 4), (2, 2),
                                               (1, 3)])
def test_pipeline_matches_sequential(n_stages, n_micro):
    d = 16
    stages = _stages(n_stages, d)
    x = np.random.default_rng(9).standard_normal(
        (n_micro * 4, d)).astype(np.float32)
    want = np.asarray(jpp.sequential_apply(_jstage, stages, x))
    jmesh = _jax_mesh(n_stages, ("stage",))
    jgot = np.asarray(jpp.make_pipeline_apply(_jstage, jmesh)(
        jpp.shard_stage_params(jpp.stack_stage_params(stages), jmesh),
        jpp.microbatch(jnp.asarray(x), n_micro)))
    tmesh = _port_mesh(n_stages, ("stage",))
    got = _n(tpp.make_pipeline_apply(_tstage, tmesh)(
        tpp.shard_stage_params(tpp.stack_stage_params(stages), tmesh),
        tpp.microbatch(_t(x), n_micro)))
    np.testing.assert_allclose(got.reshape(want.shape), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)


def test_pipeline_gradient_parity():
    """Gradients counter-rotate through the hops: d(loss)/d(stage k)
    from the port's pipeline = the sequential oracle's = the JAX
    pipeline's, for every stage."""
    n_stages, n_micro, d = 4, 4, 8
    stages = _stages(n_stages, d, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n_micro * 2, d)).astype(np.float32)
    y = rng.standard_normal((n_micro * 2, d)).astype(np.float32)
    want = jax.grad(lambda st: jnp.mean(
        (jpp.sequential_apply(_jstage, st, x) - y) ** 2))(stages)
    jmesh = _jax_mesh(n_stages, ("stage",))
    japply = jpp.make_pipeline_apply(_jstage, jmesh)
    jgot = jax.grad(lambda st: jnp.mean(
        (japply(st, jpp.microbatch(x, n_micro))
         - jpp.microbatch(y, n_micro)) ** 2))(
        jpp.shard_stage_params(jpp.stack_stage_params(stages), jmesh))
    tmesh = _port_mesh(n_stages, ("stage",))
    stacked = tpp.shard_stage_params(tpp.stack_stage_params(stages), tmesh)
    preds = tpp.make_pipeline_apply(_tstage, tmesh)(
        stacked, tpp.microbatch(_t(x), n_micro))
    loss = torch.mean((preds - tpp.microbatch(_t(y), n_micro)) ** 2)
    gb, gw = torch.autograd.grad(loss, (stacked["b"], stacked["w"]))
    for s in range(n_stages):
        for got, name in ((gw, "w"), (gb, "b")):
            np.testing.assert_allclose(_n(got[s]), np.asarray(want[s][name]),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(_n(got[s]),
                                       np.asarray(jgot[name][s]),
                                       rtol=1e-4, atol=1e-5)


def test_pipeline_train_step_learns():
    n_stages, n_micro, d = 4, 8, 8
    tmesh = _port_mesh(n_stages, ("stage",))
    stacked = tpp.shard_stage_params(
        tpp.stack_stage_params(_stages(n_stages, d, seed=5)), tmesh)
    step = tpp.make_pipeline_train_step(
        _tstage, AdamW(tree_leaves(stacked), 1e-2, 0.0), tmesh)
    x = _t(np.random.default_rng(6).standard_normal((n_micro * 4, d)))
    xs, ys = tpp.microbatch(x, n_micro), tpp.microbatch(0.5 * x, n_micro)
    losses = []
    for _ in range(60):
        stacked, loss = step(stacked, xs, ys)
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0], losses[::10]
    assert stacked["w"].shape[0] == n_stages


def test_microbatch_validates():
    with pytest.raises(ValueError, match="not divisible") as jerr:
        jpp.microbatch(jnp.zeros((10, 4)), 3)
    with pytest.raises(ValueError, match="not divisible") as terr:
        tpp.microbatch(torch.zeros((10, 4)), 3)
    assert str(terr.value) == str(jerr.value)
    assert tuple(tpp.microbatch(torch.zeros((12, 4)), 3).shape) \
        == tuple(jpp.microbatch(jnp.zeros((12, 4)), 3).shape)


# ── expert parallelism (tests/test_expert.py) ────────────────────────

N_EXPERTS = 8
D_MODEL, D_HIDDEN = 16, 32


def _moe(b=64, seed=0):
    params = jax.tree_util.tree_map(np.asarray, jex.init_moe_params(
        jax.random.PRNGKey(seed), N_EXPERTS, D_MODEL, D_HIDDEN))
    tokens = np.random.default_rng(seed + 1).standard_normal(
        (b, D_MODEL)).astype(np.float32)
    return params, tokens


def _jmoe(params, tokens, capacity_factor):
    mesh = _jax_mesh(N_EXPERTS, ("expert",))
    y, aux = jex.make_moe_apply(mesh, capacity_factor=capacity_factor)(
        jex.shard_moe_params(params, mesh),
        jax.device_put(tokens, NamedSharding(mesh, JP("expert"))))
    return np.asarray(y), {k: float(v) for k, v in aux.items()}


def _tmoe(params, tokens, capacity_factor):
    mesh = _port_mesh(N_EXPERTS, ("expert",))
    sharded = tex.shard_moe_params(tex.moe_params_from_numpy(params), mesh)
    return sharded, tex.make_moe_apply(
        mesh, capacity_factor=capacity_factor)(sharded, _t(tokens))


def test_moe_matches_dense_oracle():
    params, tokens = _moe()
    want = np.asarray(jex.moe_apply_dense(params, tokens))
    tdense = _n(tex.moe_apply_dense(tex.moe_params_from_numpy(params),
                                    _t(tokens)))
    jy, jaux = _jmoe(params, tokens, float(N_EXPERTS))
    _, (y, aux) = _tmoe(params, tokens, float(N_EXPERTS))
    assert float(aux["dropped_frac"].detach()) == jaux["dropped_frac"] == 0.0
    np.testing.assert_allclose(_n(y), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_n(y), jy, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tdense, want, rtol=1e-4, atol=1e-5)


def test_moe_load_balance_loss_bounds():
    params, tokens = _moe(b=128, seed=3)
    _, jaux = _jmoe(params, tokens, float(N_EXPERTS))
    _, (_, aux) = _tmoe(params, tokens, float(N_EXPERTS))
    lbl = float(aux["load_balance_loss"].detach())
    assert 0.9 <= lbl <= N_EXPERTS, lbl
    np.testing.assert_allclose(lbl, jaux["load_balance_loss"], rtol=1e-5)


def test_moe_capacity_drops_are_zero_vectors():
    params, tokens = _moe(b=64, seed=5)
    params = dict(params, router=np.zeros_like(params["router"]))
    jy, jaux = _jmoe(params, tokens, 0.5)
    _, (y, aux) = _tmoe(params, tokens, 0.5)
    got = _n(y)
    dropped = float(aux["dropped_frac"].detach())
    assert dropped == jaux["dropped_frac"]
    assert abs(dropped - 7 / 8) < 1e-6, dropped
    zero_rows = np.abs(got).max(axis=1) == 0.0
    # the same tokens drop (argmax ties go to expert 0 in both)
    np.testing.assert_array_equal(zero_rows, np.abs(jy).max(axis=1) == 0.0)
    assert abs(zero_rows.mean() - dropped) < 0.05
    np.testing.assert_allclose(got, jy, rtol=1e-4, atol=1e-5)


def test_moe_gradients_flow_to_experts_and_router():
    params, tokens = _moe(b=64, seed=7)
    mesh = _jax_mesh(N_EXPERTS, ("expert",))
    japply = jex.make_moe_apply(mesh, capacity_factor=float(N_EXPERTS))
    tok_sh = jax.device_put(tokens, NamedSharding(mesh, JP("expert")))

    def jloss(p):
        y, aux = japply(p, tok_sh)
        return jnp.mean(y ** 2) + 0.01 * aux["load_balance_loss"]

    jgrads = jax.grad(jloss)(jex.shard_moe_params(params, mesh))
    sharded, (y, aux) = _tmoe(params, tokens, float(N_EXPERTS))
    loss = torch.mean(y ** 2) + 0.01 * aux["load_balance_loss"]
    names = ("router", "w1", "b1", "w2", "b2")
    grads = dict(zip(names, torch.autograd.grad(
        loss, [sharded[k] for k in names])))
    for name in ("router", "w1", "w2"):
        g = _n(grads[name])
        assert np.isfinite(g).all(), name
        assert np.abs(g).max() > 0, f"no gradient reached {name}"
    for name in names:
        np.testing.assert_allclose(_n(grads[name]), np.asarray(jgrads[name]),
                                   rtol=1e-4, atol=1e-5)


def test_moe_tokens_must_divide_expert_axis():
    params, _ = _moe()
    mesh = _port_mesh(N_EXPERTS, ("expert",))
    apply_fn = tex.make_moe_apply(mesh)
    with pytest.raises(ValueError, match="divisible"):
        apply_fn(tex.shard_moe_params(tex.moe_params_from_numpy(params),
                                      mesh), torch.zeros((30, D_MODEL)))


def test_init_moe_params_within_4_ulp():
    want = jex.init_moe_params(jax.random.PRNGKey(0), N_EXPERTS, D_MODEL,
                               D_HIDDEN)
    got = tex.init_moe_params(prng.prng_key(0), N_EXPERTS, D_MODEL,
                              D_HIDDEN)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = _n(got[k])
        assert g.shape == w.shape and g.dtype == w.dtype
        ulp = np.abs(g.view(np.int32).astype(np.int64)
                     - w.view(np.int32).astype(np.int64))
        assert ulp.max() <= 4, k


def test_public_names_match():
    import routest_tpu.parallel as jpar
    import routest_tpu_torch.parallel as tpar

    assert tpar.__all__ == jpar.__all__
    for name in jpar.__all__:
        assert callable(getattr(tpar, name))
