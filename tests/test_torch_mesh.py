"""The port's mesh, per-shard programs and multi-process runtime
(``routest_tpu_torch/core/{mesh,smap,distributed}.py``) against the JAX
package's (``routest_tpu/core/{mesh,smap,distributed}.py``).

- Meshes: the same axis shapes as JAX's for the same ``MeshConfig`` over
  8 devices (the port's: ``[torch.device("cpu")] * 8``, the tests'
  stand-in for JAX's 8 virtual CPU devices), the same error text when a
  mesh needs more devices than it has; the default device list counts
  the real devices (one CPU here); ``pad_to_multiple`` and ``pad_rows``
  bitwise; ``RTPU_MESH_DATA``/``RTPU_MESH_MODEL`` read as JAX reads them.
- Collectives: ``psum``, ``pmean``, ``all_gather`` (stacked and tiled),
  ``ppermute``, ``all_to_all`` and ``axis_index`` inside ``shard_map``
  at 2, 4 and 8 shards, and over either axis of a 4×2 mesh, against the
  JAX ``lax`` collectives in a JAX ``shard_map`` on the same inputs —
  integer-valued inputs bitwise; their gradients against JAX's.
- The multi-process runtime: ``hybrid_mesh``'s single-process fallback,
  the env precedence of ``initialize``, one data-parallel train step in
  a one-process gloo group, and the counterparts of
  ``test_two_process_data_parallel_train_step`` and
  ``test_two_process_elastic_resume`` as two gloo processes of four CPU
  shards each (a data axis of 8), held to the JAX package's result on
  its 8-device mesh. Every process exits before its test ends.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from routest_tpu.core import config as jconfig
from routest_tpu.core import mesh as jmesh
from routest_tpu.core.smap import shard_map as jshard_map
from routest_tpu_torch.core import config as tconfig
from routest_tpu_torch.core import distributed as tdist
from routest_tpu_torch.core import mesh as tmesh
from routest_tpu_torch.core import smap
from routest_tpu_torch.core.smap import P, shard_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_mesh(shape, names):
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [CPU] * grid.size
    return tmesh.Mesh(grid.reshape(shape), names)


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return JMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


# ── meshes ───────────────────────────────────────────────────────────


@pytest.mark.parametrize("data,model", [(-1, 1), (4, 2), (2, 4), (8, 1),
                                        (-1, 2), (2, 1)])
def test_mesh_shapes_match_jax(data, model):
    want = jmesh.MeshRuntime.create(jconfig.MeshConfig(data=data,
                                                       model=model))
    got = tmesh.MeshRuntime.create(tconfig.MeshConfig(data=data,
                                                      model=model),
                                   devices=[CPU] * 8)
    assert dict(got.mesh.shape) == dict(want.mesh.shape)
    assert got.mesh.axis_names == tuple(want.mesh.axis_names)
    assert (got.data_axis, got.model_axis, got.n_data) \
        == (want.data_axis, want.model_axis, want.n_data)
    assert got.device == CPU and got.is_primary


@pytest.mark.parametrize("data,model", [(9, 1), (4, 4), (3, 3)])
def test_mesh_too_big_has_the_jax_error(data, model):
    with pytest.raises(ValueError) as jerr:
        jmesh.create_mesh(jconfig.MeshConfig(data=data, model=model))
    with pytest.raises(ValueError) as terr:
        tmesh.create_mesh(tconfig.MeshConfig(data=data, model=model),
                          devices=[CPU] * 8)
    assert str(terr.value) == str(jerr.value)


def test_default_devices_count_the_real_devices():
    # devices repeat only where the caller passes them: this host has
    # one CPU and no card
    assert tmesh.default_devices() == [CPU]
    assert tmesh.default_devices("cpu") == [CPU]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.default_devices("cuda")
    assert dict(tmesh.create_mesh().shape) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        tmesh.create_mesh(tconfig.MeshConfig(data=2))


def test_pad_helpers_bitwise():
    for n in (0, 1, 5, 8, 9, 63, 64, 65):
        for m in (0, 1, 2, 3, 8):
            assert tmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)
    a = np.arange(30, dtype=np.float32).reshape(10, 3)
    for target in (10, 12, 16):
        np.testing.assert_array_equal(tmesh.pad_rows(a, target),
                                      jmesh.pad_rows(a, target))
    with pytest.raises(ValueError) as jerr:
        jmesh.pad_rows(a, 4)
    with pytest.raises(ValueError) as terr:
        tmesh.pad_rows(a, 4)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("env", [{}, {"RTPU_MESH_DATA": "4"},
                                 {"RTPU_MESH_DATA": "2",
                                  "RTPU_MESH_MODEL": "4"}])
def test_mesh_config_from_env(env):
    assert tconfig.load_config(env).mesh.__dict__ \
        == jconfig.load_config(env).mesh.__dict__


def test_shard_batch_and_replicate():
    rt = tmesh.MeshRuntime.create(tconfig.MeshConfig(data=4),
                                  devices=[CPU] * 8)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    got = rt.shard_batch({"x": x, "y": x[:, 0]})
    assert torch.equal(got["x"], torch.from_numpy(x))
    assert rt.batch_sharding() == P("data") and rt.replicated() == P()
    with pytest.raises(ValueError, match="not divisible"):
        rt.shard_batch(x[:6])
    rep = rt.replicate((x, 3.0))
    assert torch.equal(rep[0], torch.from_numpy(x))


# ── collectives against lax's ────────────────────────────────────────


def _collectives(lib, n):
    """(name, per-shard program) for either package's collectives."""
    perm = [(i, (i + 1) % n) for i in range(n)]
    if lib == "jax":
        lax = jax.lax
        return {
            "psum": lambda x: lax.psum(x, "i"),
            "pmean": lambda x: lax.pmean(x, "i"),
            "all_gather": lambda x: lax.all_gather(x, "i", axis=1),
            "all_gather_tiled": lambda x: lax.all_gather(x, "i", axis=1,
                                                         tiled=True),
            "ppermute": lambda x: lax.ppermute(x, "i", perm),
            "all_to_all": lambda x: lax.all_to_all(x, "i", 1, 0,
                                                   tiled=True),
            "axis_index": lambda x: x * lax.axis_index("i"),
        }
    return {
        "psum": lambda x: smap.psum(x, "i"),
        "pmean": lambda x: smap.pmean(x, "i"),
        "all_gather": lambda x: smap.all_gather(x, "i", axis=1),
        "all_gather_tiled": lambda x: smap.all_gather(x, "i", axis=1,
                                                      tiled=True),
        "ppermute": lambda x: smap.ppermute(x, "i", perm),
        "all_to_all": lambda x: smap.all_to_all(x, "i", 1, 0),
        "axis_index": lambda x: x * smap.axis_index("i"),
    }


@pytest.mark.parametrize("n", [2, 4, 8])
def test_collectives_match_lax(n):
    x = np.arange(n * 2 * 8, dtype=np.float32).reshape(n * 2, 8)
    jm, tm = _jax_mesh((n,), ("i",)), _port_mesh((n,), ("i",))
    jfns, tfns = _collectives("jax", n), _collectives("torch", n)
    for name in jfns:
        want = np.asarray(jshard_map(jfns[name], jm, in_specs=(JP("i"),),
                                     out_specs=JP("i"))(x))
        got = shard_map(tfns[name], tm, (P("i"),), P("i"))(
            torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("axis", ["data", "model"])
def test_collectives_over_one_axis_of_a_2d_mesh(axis):
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    jm = _jax_mesh((4, 2), ("data", "model"))
    tm = _port_mesh((4, 2), ("data", "model"))
    spec = ("data", "model")

    def jprog(x):
        return (jax.lax.psum(x, axis)
                + jax.lax.axis_index(axis) * 100.0
                + jax.lax.all_gather(x, axis, axis=0, tiled=True)[:1])

    def tprog(x):
        return (smap.psum(x, axis) + smap.axis_index(axis) * 100.0
                + smap.all_gather(x, axis, axis=0, tiled=True)[:1])

    want = np.asarray(jshard_map(jprog, jm, in_specs=(JP(*spec),),
                                 out_specs=JP(*spec))(x))
    got = shard_map(tprog, tm, (P(*spec),), P(*spec))(
        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["psum", "all_gather_tiled", "ppermute",
                                  "all_to_all"])
def test_collective_gradients_match_jax(name):
    n = 4
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n * 2, 8)).astype(np.float32)
    jfn = _collectives("jax", n)[name]
    tfn = _collectives("torch", n)[name]
    jm, tm = _jax_mesh((n,), ("i",)), _port_mesh((n,), ("i",))
    japply = jshard_map(lambda x: jnp.sin(jfn(x)), jm, in_specs=(JP("i"),),
                        out_specs=JP("i"))
    w = rng.standard_normal(japply(x).shape).astype(np.float32)
    want = jax.grad(lambda x: (japply(x) * w).sum())(x)
    tx = torch.from_numpy(x).requires_grad_()
    out = shard_map(lambda x: torch.sin(tfn(x)), tm, (P("i"),), P("i"))(tx)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tx)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_replicated_inputs_and_outputs_carry_true_gradients():
    """A replicated input gathers every shard's cotangent; a replicated
    output read from one shard reaches every peer it summed."""
    tm = _port_mesh((4,), ("i",))
    w = torch.tensor([2.0, 3.0], requires_grad=True)
    x = torch.arange(8.0).reshape(4, 2)
    out = shard_map(lambda w, x: smap.psum((x * w).sum(), "i"), tm,
                    (P(), P("i")), P())(w, x)
    (g,) = torch.autograd.grad(out, w)
    assert float(out.detach()) == float((x * w).sum().detach())
    assert torch.equal(g, x.sum(0))


def test_shard_map_errors_surface():
    tm = _port_mesh((4,), ("i",))
    with pytest.raises(ValueError, match="not divisible"):
        shard_map(lambda x: x, tm, (P("i"),), P("i"))(torch.zeros(6))
    with pytest.raises(RuntimeError, match="outside a shard_map"):
        smap.psum(torch.zeros(1), "i")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        shard_map(lambda x: smap.psum(x, "j"), tm, (P("i"),),
                  P("i"))(torch.zeros(4))

    def one_shard_fails(x):
        if smap.axis_index("i") == 2:
            raise KeyError("shard 2")
        return smap.psum(x, "i")   # the others wait here: no hang

    with pytest.raises(KeyError, match="shard 2"):
        shard_map(one_shard_fails, tm, (P("i"),), P("i"))(torch.zeros(4))


def test_replica_on_is_the_module_on_its_own_device():
    lin = torch.nn.Linear(3, 2)
    assert smap.replica_on(lin, CPU) is lin
    # a copy whose parameters derive from the module's (the path for a
    # shard on another device) still trains the module's own parameters
    copy = smap._copy_to(lin, CPU)
    assert copy is not lin and "weight" not in copy._parameters
    (gw,) = torch.autograd.grad(copy(torch.ones(1, 3)).sum(), lin.weight)
    assert torch.equal(gw, torch.ones(2, 3))


# ── the multi-process runtime (tests/test_distributed.py) ────────────


def test_hybrid_mesh_single_process_fallback():
    from routest_tpu.core import distributed as jdist

    cpus = [CPU] * 8
    for kwargs in ({}, {"model": 2},
                   {"ici_data": 2, "dcn_data": 1, "model": 1}):
        want = jdist.hybrid_mesh(**kwargs)
        got = tdist.hybrid_mesh(devices=cpus, **kwargs)
        assert dict(got.shape) == dict(want.shape), kwargs
        assert got.axis_names == tuple(want.axis_names)
        assert got.processes == 1


def test_env_var_plumbing(monkeypatch):
    import torch.distributed as dist

    seen = {}

    def fake_init(backend, init_method=None, world_size=None, rank=None):
        seen.update(backend=backend, init=init_method, n=world_size,
                    pid=rank)

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(tdist, "_initialized", False)
    monkeypatch.setenv("RTPU_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("RTPU_NUM_PROCESSES", "16")
    monkeypatch.setenv("RTPU_PROCESS_ID", "3")
    tdist.initialize()
    assert seen == {"backend": "gloo", "init": "tcp://10.0.0.1:1234",
                    "n": 16, "pid": 3}
    assert tdist.is_initialized()
    seen.clear()
    tdist.initialize()           # idempotent: a no-op
    assert seen == {}
    # explicit kwargs win over the environment
    monkeypatch.setattr(tdist, "_initialized", False)
    tdist.initialize("127.0.0.1:9", num_processes=2, process_id=1)
    assert seen == {"backend": "gloo", "init": "tcp://127.0.0.1:9",
                    "n": 2, "pid": 1}
    # without either, torch's own env:// (what torchrun sets)
    monkeypatch.setattr(tdist, "_initialized", False)
    for name in ("RTPU_COORDINATOR", "RTPU_NUM_PROCESSES",
                 "RTPU_PROCESS_ID"):
        monkeypatch.delenv(name)
    tdist.initialize()
    assert seen["init"] == "env://"
    monkeypatch.setattr(tdist, "_initialized", False)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_STEP_CHILD = """
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from routest_tpu_torch.core import distributed
runtime = distributed.multihost_runtime(devices=[torch.device("cpu")] * 4)
assert runtime.mesh.processes == {procs}, runtime.mesh
assert runtime.n_data == {n_data}, runtime.n_data
from routest_tpu_torch.core import prng
from routest_tpu_torch.core.config import TrainConfig
from routest_tpu_torch.core.dtypes import F32_POLICY
from routest_tpu_torch.data.features import batch_from_mapping
from routest_tpu_torch.data.synthetic import generate_dataset
from routest_tpu_torch.models.eta_mlp import EtaMLP, fit_normalizer
from routest_tpu_torch.train.loop import make_optimizer, make_train_step
model = EtaMLP(hidden=(16,), policy=F32_POLICY)
data = generate_dataset(64, seed=0)
features = batch_from_mapping(data)
targets = np.asarray(data["eta_minutes"], np.float32)
mean, std = fit_normalizer(features)
model.init(prng.prng_key(0), norm_mean=mean, norm_std=std)
opt = make_optimizer(model, TrainConfig(), total_steps=4)
step = make_train_step(model, opt, runtime)
batch = runtime.shard_batch((features, targets, np.ones(64, np.float32)))
for _ in range(2):
    loss = step(*batch)
norm = float(torch.linalg.norm(model.layers[0].weight))
print(f"TWOPROC loss={{float(loss):.10f}} wnorm={{norm:.10f}}", flush=True)
distributed.shutdown()
"""


def _run_group(code, n_proc, extra_env=None, timeout=240):
    port = _free_port()
    procs = []
    for pid in range(n_proc):
        env = dict(os.environ, RTPU_COORDINATOR=f"127.0.0.1:{port}",
                   RTPU_NUM_PROCESSES=str(n_proc), RTPU_PROCESS_ID=str(pid),
                   **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _jax_step_oracle():
    """The JAX package's two steps on its 8-device mesh (the JAX tests'
    single-process oracle), in this process."""
    from routest_tpu.core.config import TrainConfig
    from routest_tpu.core.dtypes import F32_POLICY
    from routest_tpu.data.features import batch_from_mapping
    from routest_tpu.data.synthetic import generate_dataset
    from routest_tpu.models.eta_mlp import EtaMLP, fit_normalizer
    from routest_tpu.train.loop import (Batch, TrainState, make_optimizer,
                                        make_train_step)

    runtime = jmesh.MeshRuntime.create()
    model = EtaMLP(hidden=(16,), policy=F32_POLICY)
    data = generate_dataset(64, seed=0)
    features = batch_from_mapping(data)
    targets = np.asarray(data["eta_minutes"], np.float32)
    mean, std = fit_normalizer(features)
    params = model.init(jax.random.PRNGKey(0), norm_mean=mean, norm_std=std)
    optimizer = make_optimizer(TrainConfig(), total_steps=4)
    state = TrainState(params, optimizer.init(params),
                       jnp.zeros((), jnp.int32))
    state = TrainState(*runtime.replicate(tuple(state)))
    step = make_train_step(model, optimizer, runtime)
    batch = Batch(*runtime.shard_batch(
        (features, targets, np.ones(64, np.float32))))
    for _ in range(2):
        state, loss = step(state, batch)
    w0 = np.asarray(state.params["layers"][0]["w"], np.float32)
    return float(loss), float(np.linalg.norm(w0))


def _parse(line):
    return [float(kv.split("=")[1]) for kv in line.split()[1:]]


def test_initialize_and_train_step_one_process():
    """multihost_runtime on one gloo process: a local data axis of 4
    shards, and the ordinary data-parallel step through it."""
    (out,) = _run_group(_STEP_CHILD.format(procs=1, n_data=4), 1)
    line = next(ln for ln in out.splitlines() if ln.startswith("TWOPROC"))
    loss, _ = _parse(line)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, _jax_step_oracle()[0], rtol=1e-4)


def test_two_process_data_parallel_train_step():
    """Two OS processes, four CPU shards each, one global data axis of 8:
    the gradient reduction crosses the process boundary over gloo. Both
    processes report the identical loss and weights, and they match the
    JAX package's steps on its 8-device mesh (the port's init draws
    within 4 ulp of JAX's: the fit class, rtol 1e-4)."""
    outs = _run_group(_STEP_CHILD.format(procs=2, n_data=8), 2)
    lines = [next(ln for ln in o.splitlines() if ln.startswith("TWOPROC"))
             for o in outs]
    assert lines[0] == lines[1], f"processes disagree: {lines}"
    np.testing.assert_allclose(_parse(lines[0]), _jax_step_oracle(),
                               rtol=1e-4)


_ELASTIC_CHILD = """
import os
import torch
torch.set_num_threads(1)
from routest_tpu_torch.core import distributed
runtime = distributed.multihost_runtime(devices=[torch.device("cpu")] * 4)
from routest_tpu_torch.core.config import TrainConfig
from routest_tpu_torch.core.dtypes import F32_POLICY
from routest_tpu_torch.data.synthetic import generate_dataset
from routest_tpu_torch.models.eta_mlp import EtaMLP
from routest_tpu_torch.train.loop import fit
model = EtaMLP(hidden=(16,), policy=F32_POLICY)
data = generate_dataset(512, seed=0)
ev = generate_dataset(128, seed=1)
ckpt = os.environ.get("ELASTIC_CKPT") or None
stop = int(os.environ.get("ELASTIC_STOP", "0")) or None
res = fit(model, data, ev, TrainConfig(batch_size=128, epochs=4, seed=0,
                                       checkpoint_dir=ckpt,
                                       checkpoint_every_epochs=1,
                                       stop_after_epochs=stop),
          runtime=runtime)
norm = float(torch.linalg.norm(model.layers[0].weight))
print(f"ELASTIC wnorm={norm:.10f} loss={res.train_losses[-1]:.10f}",
      flush=True)
distributed.shutdown()
"""


def _elastic_pair(stop_after, ckpt_dir):
    outs = _run_group(_ELASTIC_CHILD, 2, {"ELASTIC_STOP": str(stop_after),
                                          "ELASTIC_CKPT": ckpt_dir})
    lines = [next(ln for ln in o.splitlines() if ln.startswith("ELASTIC"))
             for o in outs]
    assert lines[0] == lines[1], f"processes disagree: {lines}"
    return lines[0]


def test_two_process_elastic_resume(tmp_path):
    """A two-process job on a 4-epoch schedule is preempted after epoch
    2, a replacement pair resumes from the shared checkpoint directory
    (process 0 writes it), and reaches the exact epoch-4 result of an
    uninterrupted pair — which matches the JAX ``fit`` on its 8-device
    mesh within the fit class (rtol 1e-4)."""
    from routest_tpu.core.config import TrainConfig
    from routest_tpu.core.dtypes import F32_POLICY
    from routest_tpu.data.synthetic import generate_dataset
    from routest_tpu.models.eta_mlp import EtaMLP
    from routest_tpu.train.loop import fit

    shared = str(tmp_path / "ckpt")
    _elastic_pair(2, shared)                     # preempted after epoch 2
    assert sorted(os.listdir(shared)) == ["step_00000001.pt",
                                          "step_00000002.pt"]
    resumed = _elastic_pair(0, shared)           # the replacement resumes
    uninterrupted = _elastic_pair(0, "")
    assert resumed == uninterrupted, (resumed, uninterrupted)
    res = fit(EtaMLP(hidden=(16,), policy=F32_POLICY),
              generate_dataset(512, seed=0), generate_dataset(128, seed=1),
              TrainConfig(batch_size=128, epochs=4, seed=0),
              runtime=jmesh.MeshRuntime.create())
    w0 = np.asarray(res.state.params["layers"][0]["w"], np.float32)
    np.testing.assert_allclose(
        _parse(uninterrupted),
        [float(np.linalg.norm(w0)), res.train_losses[-1]], rtol=1e-4)


def test_distributed_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import routest_tpu_torch.core.distributed, "
         "routest_tpu_torch.core.smap, routest_tpu_torch.parallel\n"
         "print(sorted(m for m in sys.modules if m == 'jax' or "
         "m.startswith(('jax.', 'routest_tpu.')) or m == 'routest_tpu'))"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"

