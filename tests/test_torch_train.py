"""The port's ETA training slice against the JAX package on the CPU:
the same seeded numpy inputs through ``routest_tpu`` and
``routest_tpu_torch``.

Tolerances: the dataset, the split and CSV round trips are bitwise;
``init`` draws within 4 ulp (XLA's ``log1p`` inside ``erf_inv`` is not
torch's; most draws are bitwise); losses, one step's grads and params
and a whole f32 ``fit`` within rtol 1e-5 (losses, grads, rmse) or 1e-4
(params after several steps, with atol 1e-6 for entries that cross
zero); a bf16-policy ``fit`` within rtol 2e-2 of the JAX bf16 run
(different bf16 rounding paths). The port's own resume is bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from routest_tpu.core.config import TrainConfig as JTrainConfig
from routest_tpu.core.dtypes import DEFAULT_POLICY as JBF16
from routest_tpu.core.dtypes import F32_POLICY as JF32
from routest_tpu.data import csv_io as jcsv
from routest_tpu.data import synthetic as jsyn
from routest_tpu.models.eta_mlp import EtaMLP as JEtaMLP
from routest_tpu.train import loop as jloop
from routest_tpu.train.checkpoint import load_model as jload_model
from routest_tpu_torch.core import prng
from routest_tpu_torch.core.config import TrainConfig, load_config
from routest_tpu_torch.core.dtypes import DEFAULT_POLICY, F32_POLICY
from routest_tpu_torch.data import csv_io
from routest_tpu_torch.data import synthetic
from routest_tpu_torch.data.features import batch_from_mapping
from routest_tpu_torch.models.eta_mlp import EtaMLP, fit_normalizer
from routest_tpu_torch.train import checkpoint as ckpt
from routest_tpu_torch.train import loop

HIDDEN = (32, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: these tests run many small CPU ops,
    and beside the suite's other workers a full thread pool per worker
    oversubscribes the cores (its threads spin), which slowed this file
    twentyfold in the parallel run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_tree_close(got, want, rtol, atol=0.0):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray,
                                                            want))
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def data():
    return synthetic.train_eval_split(synthetic.generate_dataset(3072,
                                                                 seed=5))


# ── data ──────────────────────────────────────────────────────────────────

@pytest.mark.parametrize("n,seed,kw", [(4096, 0, {}), (2048, 7, {}),
                                       (2048, 3, {"unknown_frac": 0.3,
                                                  "noise_sigma": 0.0})])
def test_generate_dataset_and_split_bitwise(n, seed, kw):
    got = synthetic.generate_dataset(n, seed=seed, **kw)
    want = jsyn.generate_dataset(n, seed=seed, **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key
    for g, w in zip(synthetic.train_eval_split(got, eval_frac=0.2, seed=4),
                    jsyn.train_eval_split(want, eval_frac=0.2, seed=4)):
        for key in w:
            assert np.array_equal(g[key], w[key]), key


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_csv_round_trip_bitwise(tmp_path, writer):
    data = synthetic.generate_dataset(2048, seed=11, unknown_frac=0.2)
    path = str(tmp_path / "d.csv")
    (csv_io.save_csv if writer == "port" else jcsv.save_csv)(path, data)
    got = csv_io.load_csv(path)
    want = jcsv.load_csv(path, force_python=True)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key
    with open(path) as f:
        text = f.read()
    other = str(tmp_path / "o.csv")
    (jcsv.save_csv if writer == "port" else csv_io.save_csv)(other, data)
    with open(other) as f:
        assert f.read() == text


def test_csv_errors_match(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text(",".join(csv_io.COLUMNS) + "\nSunny,Low,1,2,x,30,5\n")
    with pytest.raises(ValueError) as got:
        csv_io.load_csv(str(bad))
    with pytest.raises(ValueError) as want:
        jcsv.load_csv(str(bad), force_python=True)
    assert str(got.value) == str(want.value)


def test_train_config_env():
    cfg = load_config({"RTPU_TRAIN_BATCH": "1024", "RTPU_LR": "0.01",
                       "RTPU_EPOCHS": "3", "RTPU_SEED": "9",
                       "RTPU_CKPT_DIR": "/x", "RTPU_LIVE_RETRAIN_S": "5",
                       "RTPU_LIVE_RETRAIN_STEPS": "7",
                       "RTPU_LIVE_RETRAIN_MIN_OBS": "8"})
    assert cfg.train == TrainConfig(batch_size=1024, learning_rate=0.01,
                                    epochs=3, seed=9, checkpoint_dir="/x")
    assert (cfg.live.retrain_s, cfg.live.retrain_steps,
            cfg.live.retrain_min_obs) == (5.0, 7, 8)
    assert load_config({}).train == TrainConfig()


# ── init ──────────────────────────────────────────────────────────────────

@pytest.mark.parametrize("seed,quantiles", [(0, ()), (3, (0.1, 0.5, 0.9))])
def test_init_within_4_ulp(seed, quantiles):
    """Within 4 ulp, not bitwise: the normal draw's ``erf_inv`` uses
    torch's ``log1p`` where XLA has its own."""
    mean = np.linspace(-3, 3, 12).astype(np.float32)
    std = np.linspace(0.5, 2, 12).astype(np.float32)
    std[3] = 1e-4          # constant column: floored to 1
    want = JEtaMLP(hidden=HIDDEN, policy=JF32, quantiles=quantiles).init(
        jax.random.PRNGKey(seed), mean, std)
    got = EtaMLP(hidden=HIDDEN, quantiles=quantiles).init(
        prng.prng_key(seed), mean, std).to_numpy()
    assert got["norm"]["std"][3] == 1.0
    for g, w in zip(_leaves(got), _leaves(want)):
        ulp = np.abs(g.view(np.int32).astype(np.int64)
                     - w.view(np.int32).astype(np.int64))
        assert ulp.max() <= 4


def test_normal_draw_mostly_bitwise():
    j = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (64, 256)))
    t = prng.normal(prng.prng_key(2), (64, 256)).numpy()
    assert (j == t).mean() > 0.95
    assert np.abs(j.view(np.int32).astype(np.int64)
                  - t.view(np.int32).astype(np.int64)).max() <= 4


def test_fit_normalizer_and_constant_column(data):
    train, _ = data
    x = batch_from_mapping(train)
    x[:, 11] = 30.0         # constant driver age
    mean, std = fit_normalizer(x)
    jmean, jstd = __import__("routest_tpu.models.eta_mlp",
                             fromlist=["x"]).fit_normalizer(x)
    assert np.array_equal(mean, jmean) and np.array_equal(std, jstd)
    model = EtaMLP(hidden=HIDDEN).init(prng.prng_key(0), mean, std)
    assert float(model.norm_std[11]) == 1.0
    assert torch.isfinite(model(torch.from_numpy(x[:64]))).all()


# ── loss and one step ─────────────────────────────────────────────────────

def _pair(quantiles=(), policy=(F32_POLICY, JF32), seed=0):
    jm = JEtaMLP(hidden=HIDDEN, policy=policy[1], quantiles=quantiles)
    x = batch_from_mapping(synthetic.generate_dataset(512, seed=1))
    mean, std = fit_normalizer(x)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), mean, std))
    tm = EtaMLP.from_numpy(params, hidden=HIDDEN, quantiles=quantiles,
                           policy=policy[0])
    return jm, params, tm


def _batch(n=256, seed=2, weights=None):
    d = synthetic.generate_dataset(n, seed=seed)
    x = batch_from_mapping(d)
    y = np.asarray(d["eta_minutes"], np.float32)
    w = np.ones(n, np.float32) if weights is None else weights
    return (jloop.Batch(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)),
            (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w)))


@pytest.mark.parametrize("quantiles", [(), (0.1, 0.5, 0.9)])
def test_loss_fn_matches(quantiles):
    jm, params, tm = _pair(quantiles)
    w = (np.arange(256) % 4 != 0).astype(np.float32)
    jb, tb = _batch(weights=w)
    want = float(jloop.loss_fn(jm, params, jb))
    got = float(loop.loss_fn(tm, *tb).detach())
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_loss_fn_all_weights_zero():
    jm, params, tm = _pair()
    jb, tb = _batch(weights=np.zeros(256, np.float32))
    assert float(loop.loss_fn(tm, *tb).detach()) == float(
        jloop.loss_fn(jm, params, jb)) == 0.0


def _jax_steps(jm, params, cfg, total, batches):
    opt = jloop.make_optimizer(cfg, total_steps=total)
    state = jloop.TrainState(params, opt.init(params),
                             jnp.zeros((), jnp.int32))
    step = jloop.make_train_step(jm, opt)
    out = []
    for jb in batches:
        grads = jax.grad(lambda p: jloop.loss_fn(jm, p, jb))(state.params)
        state, _ = step(state, jb)
        out.append((grads, jax.tree_util.tree_map(np.asarray,
                                                  state.params)))
    return out


@pytest.mark.parametrize("quantiles", [(), (0.1, 0.5, 0.9)])
def test_step_grads_and_params(quantiles):
    """Step 0 runs at learning rate 0 (params unchanged, Adam moments
    filled); step 1 moves them. The grad norm is far above 1 at init,
    so the clip triggers on both."""
    jm, params, tm = _pair(quantiles)
    cfg = TrainConfig(learning_rate=3e-3, weight_decay=1e-4)
    jcfg = JTrainConfig(learning_rate=3e-3, weight_decay=1e-4)
    batches = [_batch(seed=s) for s in (2, 3)]
    want = _jax_steps(jm, params, jcfg, 20, [b[0] for b in batches])
    opt = loop.make_optimizer(tm, cfg, total_steps=20)
    assert opt.lr(0) == 0.0 and opt.lr(1) > 0.0
    before = tm.to_numpy()
    for i, (_, tb) in enumerate(batches):
        loss = loop.loss_fn(tm, *tb)
        grads = torch.autograd.grad(loss, opt.params)
        jgrads = want[i][0]
        norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
        assert norm > 1.0           # the clip triggers
        for layer, (gb, gw) in enumerate(zip(grads[0::2], grads[1::2])):
            np.testing.assert_allclose(
                gw.numpy().T, np.asarray(jgrads["layers"][layer]["w"]),
                rtol=1e-5, atol=1e-6 * norm)
            np.testing.assert_allclose(
                gb.numpy(), np.asarray(jgrads["layers"][layer]["b"]),
                rtol=1e-5, atol=1e-6 * norm)
        opt.step(grads)
        if i == 0:
            _assert_tree_close(tm.to_numpy(), before, rtol=0.0)
        _assert_tree_close(tm.to_numpy(), want[i][1], rtol=1e-5, atol=1e-7)


def test_clip_formula_is_optax():
    """``g`` below norm 1, ``g / ‖g‖`` above (no epsilon), as optax."""
    import optax

    for scale in (1e-3, 10.0):
        gs = [torch.full((3,), scale), torch.full((2, 2), -scale)]
        got = loop.clip_by_global_norm(gs)
        want, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(g.numpy()) for g in gs], optax.EmptyState())
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("total", [1, 20, 1000, 5000])
def test_schedule_matches_optax(total):
    cfg = TrainConfig()
    tm = EtaMLP(hidden=HIDDEN)
    opt = loop.make_optimizer(tm, cfg, total_steps=total)
    warmup = max(1, min(100, total // 10))
    import optax

    sched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, warmup, max(total, warmup + 1),
        cfg.learning_rate * 0.05)
    for count in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                         total - 1, total, total + 7}):
        np.testing.assert_allclose(opt.lr(count), float(sched(count)),
                                   rtol=1e-6, atol=1e-12)


def test_decay_mask_and_frozen_normalizer():
    """With zero row weights the grads are zero, so a step with learning
    rate > 0 applies only the decoupled decay: weights shrink (bitwise
    as the JAX step), biases and the normalizer stay bitwise."""
    jm, params, tm = _pair()
    params = jax.tree_util.tree_map(lambda a: a + np.float32(0.25), params)
    tm = EtaMLP.from_numpy(params, hidden=HIDDEN, policy=F32_POLICY)
    jb, tb = _batch(weights=np.zeros(256, np.float32))
    want = _jax_steps(jm, params, JTrainConfig(), 20, [jb, jb])[-1][1]
    opt = loop.make_optimizer(tm, TrainConfig(), total_steps=20)
    for _ in range(2):
        opt.step(torch.autograd.grad(loop.loss_fn(tm, *tb), opt.params,
                                     allow_unused=False))
    got = tm.to_numpy()
    for layer, ref in zip(got["layers"], params["layers"]):
        assert np.array_equal(layer["b"], ref["b"])
        assert not np.array_equal(layer["w"], ref["w"])
    assert np.array_equal(got["norm"]["mean"], params["norm"]["mean"])
    assert np.array_equal(got["norm"]["std"], params["norm"]["std"])
    _assert_tree_close(got, want, rtol=1e-6)
    assert [p.requires_grad for p in tm.buffers()] == [False, False]


# ── fit ───────────────────────────────────────────────────────────────────

CFG = dict(batch_size=512, epochs=3, seed=0)


@pytest.mark.parametrize("quantiles", [(), (0.1, 0.5, 0.9)])
def test_fit_f32_matches_jax(data, quantiles):
    train, ev = data
    want = jloop.fit(JEtaMLP(hidden=HIDDEN, policy=JF32,
                             quantiles=quantiles),
                     train, ev, JTrainConfig(**CFG))
    got = loop.fit(EtaMLP(hidden=HIDDEN, policy=F32_POLICY,
                          quantiles=quantiles),
                   train, ev, TrainConfig(**CFG), device="cpu")
    assert got.optimizer.count == 3 * 6
    np.testing.assert_allclose(got.train_losses, want.train_losses,
                               rtol=1e-5)
    _assert_tree_close(got.params, want.state.params, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.eval_rmse, want.eval_rmse, rtol=1e-5)


def test_fit_bf16_policy_looser_class(data):
    train, ev = data
    want = jloop.fit(JEtaMLP(hidden=HIDDEN, policy=JBF16), train, ev,
                     JTrainConfig(**CFG))
    got = loop.fit(EtaMLP(hidden=HIDDEN, policy=DEFAULT_POLICY), train, ev,
                   TrainConfig(**CFG), device="cpu")
    np.testing.assert_allclose(got.train_losses, want.train_losses,
                               rtol=2e-2)
    np.testing.assert_allclose(got.eval_rmse, want.eval_rmse, rtol=2e-2)


def test_fit_rejects_empty_and_missing_card(data):
    train, ev = data
    empty = {k: v[:0] for k, v in train.items()}
    with pytest.raises(ValueError, match="empty"):
        loop.fit(EtaMLP(hidden=HIDDEN), empty, ev, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loop.fit(EtaMLP(hidden=HIDDEN), train, ev, device="cuda")


def _fit(train, ev, **kw):
    cfg = TrainConfig(batch_size=512, epochs=4, seed=1,
                      checkpoint_every_epochs=3, **kw)
    return loop.fit(EtaMLP(hidden=HIDDEN, policy=F32_POLICY), train, ev,
                    cfg, device="cpu")


def test_resume_two_plus_two_is_bitwise(data, tmp_path):
    train, ev = data
    whole = _fit(train, ev)
    d = str(tmp_path / "ck")
    first = _fit(train, ev, checkpoint_dir=d, stop_after_epochs=2)
    assert len(first.train_losses) == 2
    assert ckpt.latest_checkpoint_step(d)[0] == 2
    second = _fit(train, ev, checkpoint_dir=d, stop_after_epochs=2)
    assert ckpt.latest_checkpoint_step(d)[0] == 4
    assert first.train_losses + second.train_losses == whole.train_losses
    for g, w in zip(_leaves(second.params), _leaves(whole.params)):
        assert np.array_equal(g, w)
    assert second.eval_rmse == whole.eval_rmse
    assert second.optimizer.count == whole.optimizer.count


def test_stop_after_epochs_zero_and_negative(data, tmp_path):
    train, ev = data
    d = str(tmp_path / "ck")
    _fit(train, ev, checkpoint_dir=d, stop_after_epochs=3)
    state = ckpt.restore_checkpoint(ckpt.latest_checkpoint(d))
    assert state["epoch"] == 3 and state["step"] == 3 * 6
    noop = _fit(train, ev, checkpoint_dir=d, stop_after_epochs=0)
    assert noop.train_losses == [] and noop.optimizer.count == 18
    assert ckpt.latest_checkpoint_step(d)[0] == 3
    with pytest.raises(ValueError, match="stop_after_epochs"):
        _fit(train, ev, checkpoint_dir=d, stop_after_epochs=-1)


def test_periodic_checkpoints_without_budget(data, tmp_path):
    train, ev = data
    d = str(tmp_path / "ck")
    _fit(train, ev, checkpoint_dir=d)
    assert sorted(os.listdir(d)) == ["step_00000003.pt"]


def test_checkpoint_scan_ignores_temp_and_orbax(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    assert ckpt.latest_checkpoint_step(str(d)) is None
    assert ckpt.latest_checkpoint_step(str(tmp_path / "missing")) is None
    ckpt.save_checkpoint(str(d), 2, {"step": torch.tensor(2), "epoch": 2})
    (d / "step_00000009.pt.tmp123.456").write_bytes(b"partial")
    (d / "step_00000007").mkdir()                       # Orbax step dir
    (d / "step_00000008.orbax-checkpoint-tmp-1").mkdir()
    (d / "step_00000006.pt").mkdir()                    # not a file
    (d / "step_x.pt").write_bytes(b"")
    step, path = ckpt.latest_checkpoint_step(str(d))
    assert step == 2 and path.endswith("step_00000002.pt")
    assert ckpt.restore_checkpoint(path)["epoch"] == 2


def test_trained_artifact_loads_in_jax_and_v1_refused(data, tmp_path):
    train, ev = data
    result = loop.fit(EtaMLP(hidden=HIDDEN, quantiles=(0.1, 0.5, 0.9)),
                      train, ev, TrainConfig(batch_size=512, epochs=1),
                      device="cpu")
    path = str(tmp_path / "m.msgpack")
    ckpt.save_model(path, result.model)
    jmodel, jparams = jload_model(path)
    assert jmodel.quantiles == (0.1, 0.5, 0.9)
    assert jmodel.hidden == HIDDEN
    for g, w in zip(_leaves(jparams), _leaves(result.params)):
        assert np.array_equal(g, w)
    with open(path, "rb") as f:
        raw = f.read()
    v1 = raw.replace(b'"version": 3', b'"version": 1', 1)
    old = tmp_path / "v1.msgpack"
    old.write_bytes(v1)
    with pytest.raises(ValueError) as got:
        ckpt.load_model(str(old))
    with pytest.raises(ValueError) as want:
        jload_model(str(old))
    assert str(got.value) == str(want.value)
    assert "incompatible" in str(got.value)
