"""The port's split/merge fabric (``core/{cluster,coremark,reconfigure,
scheduler,sync}.py``, ``dist/{sharding,collectives}.py``,
``launch/mesh.py``) against the JAX package's.

CPU: the port over ``devices=["cpu"] * 8`` (eight lanes) against the JAX
package over 8 forced host devices, run once in a subprocess that writes an
``.npz`` (module fixture):
- the cluster's views and ``surviving_cluster`` sizes at n_pods 1, 2 and 4,
  the refusals, and ``launch/mesh.py``'s views;
- ``coremark`` checksums at several (iterations, seed): equal;
- ``run_merged`` and ``run_split_staged`` of ``fft2d_kernel(rounds=2)`` and
  ``matmul_chain_kernel(rounds=2)`` on [16, 16] inputs from a numpy seed,
  within rtol 1e-4 and atol 1e-4 x max |JAX| (f32 sums in other orders);
- ``switch_mode`` / ``reshard`` values (equal) and ``bytes_moved`` (48 for
  the 3 x 4 case, 256 for the 8 x 8 case), the shrink onto
  ``surviving_cluster(0).pod_info(0)`` (the survivors' shards kept, not
  copied), and ``device_put`` / ``gather`` / ``constraint`` round trips;
- the scheduler's records in all three paths: lanes, kinds, the round-robin
  assignment, and overlap in MERGE (as ``tests/test_core.py``);
- the ring matmuls over 4 lanes (and rings of a 2-D mesh) against ``a @ w``
  and JAX's ``shard_map`` results, rtol 2e-4 (the JAX test's);
- no module under ``src/repro_torch/`` imports ``jax`` or ``repro``.

The ``cuda`` tests (skipped without a card): two lanes on one card have
streams of their own; a merged FFT run makes no device-to-host copy between
its rounds (profiler count) and equals the CPU run; the ring matmuls and a
switch on two lanes of one card; a hand-written kernel as the first CUDA
work of a scheduler's controller thread in every path; a launch on a second
card's lane leaving the caller's current device as it was (two cards).
"""

import ast
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (
    MixedScheduler,
    Mode,
    ScalarTask,
    SpatzformerCluster,
    TwoPhaseKernel,
    VectorTask,
    coremark,
    fft2d_kernel,
    matmul_chain_kernel,
    reshard,
    run_merged,
    run_split_staged,
    switch_mode,
)
from repro_torch.dist.collectives import ring_ag_matmul, ring_rs_matmul
from repro_torch.dist.sharding import (
    Mesh,
    NamedSharding,
    P,
    ShardedTensor,
    device_put,
    gather,
    lanes_for,
    param_shardings,
)
from repro_torch.launch import mesh_info_for, serving_mesh_infos

ROOT = Path(__file__).resolve().parents[1]
CPU8 = ["cpu"] * 8
RTOL = 1e-4
RING_RTOL = 2e-4
SLEEP = 0.05  # a vector task's stand-in device time
COREMARK_CASES = ((1, 0x3415), (3, 0), (5, 7), (20, 0x3415), (2, 123456789))

_JAX_FABRIC = r"""
import sys, time
import repro  # noqa: F401
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import (SpatzformerCluster, Mode, MixedScheduler, ScalarTask, VectorTask,
                        coremark, fft2d_kernel, matmul_chain_kernel, reshard, run_merged,
                        run_split_staged, switch_mode)
from repro.dist.collectives import ring_rs_matmul, ring_ag_matmul
from repro.launch.mesh import serving_mesh_infos

assert len(jax.devices()) == 8
out = {}
for n in (1, 2, 4):
    cl = SpatzformerCluster(n_pods=n)
    mi, si = cl.merge_info(), cl.split_infos()
    row = [cl.n_devices, *cl.pod_shape, mi.n_devices, mi.data_size, mi.model_size, len(si),
           si[0].n_devices, si[0].data_size, si[0].model_size]
    if n > 1:
        s = cl.surviving_cluster(0)
        row += [s.n_pods, s.n_devices, s.pod_info(0).n_devices, s.merge_info().data_size]
    out[f"views{n}"] = np.array(row)
for mode in ("split", "merge"):
    out[f"serving_{mode}"] = np.array([[i.n_devices, i.data_size, i.model_size]
                                       for i in serving_mesh_infos(mode, jax.devices()[:4])])

rng = np.random.default_rng(0)
x = (rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))).astype(np.complex64)
xr = rng.standard_normal((16, 16)).astype(np.float32)
w1 = (rng.standard_normal((16, 16)) / 4).astype(np.float32)
w2 = (rng.standard_normal((16, 16)) / 4).astype(np.float32)
out.update(x=x, xr=xr, w1=w1, w2=w2)
cl = SpatzformerCluster(n_pods=2)
for tag, k, xx in (("fft", fft2d_kernel(rounds=2), x),
                   ("chain", matmul_chain_kernel(jnp.asarray(w1), jnp.asarray(w2), rounds=2), xr)):
    out[f"{tag}_merged"] = run_merged(k, xx, cl, repeats=1)[0]
    out[f"{tag}_split"] = run_split_staged(k, xx, cl, repeats=1)[0]

one = SpatzformerCluster(n_pods=1, pod_shape=(1, 1), devices=jax.devices()[:1])
w = jnp.arange(12.0).reshape(3, 4)
o, rep = switch_mode(one, Mode.MERGE, {"w": w})
o2, rep2 = switch_mode(one, Mode.SPLIT, o)
out["switch34"] = np.asarray(o2["w"])
out["bytes34"] = np.array([rep.bytes_moved, rep2.bytes_moved])
x8 = jnp.arange(64.0).reshape(8, 8)
si = cl.split_infos()
state = jax.device_put({"w": x8}, si[0].named(P("data", None)))
merged, rep = switch_mode(cl, Mode.MERGE, state)
out["switch88"] = np.asarray(merged["w"])
out["bytes88"] = np.array(rep.bytes_moved)
out["shrunk88"] = np.asarray(reshard(merged, cl.surviving_cluster(dead_pod=0).pod_info(0))["w"])

mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("model",))
a = rng.standard_normal((16, 32)).astype(np.float32)
wm = rng.standard_normal((32, 24)).astype(np.float32)
f = jax.jit(jax.shard_map(lambda xl, wl: ring_rs_matmul(xl, wl, "model"), mesh=mesh,
    in_specs=(P(None, "model"), P("model", None)), out_specs=P("model", None)))
g = jax.jit(jax.shard_map(lambda xl, wl: ring_ag_matmul(xl, wl, "model"), mesh=mesh,
    in_specs=(P("model", None), P(None, "model")), out_specs=P(None, "model")))
out.update(a=a, wm=wm, rs=np.asarray(f(a, wm)), ag=np.asarray(g(a, wm)))

sched = MixedScheduler(cl)
def vec(info):
    time.sleep(%r)
    return info.n_devices
recs = []
for mode, nv, scalar in ((Mode.MERGE, 3, True), (Mode.SPLIT, 3, True), (Mode.SPLIT, 4, False)):
    rep = sched.run(mode, [VectorTask(f"v{i}", vec) for i in range(nv)],
                    [ScalarTask("cm", lambda: coremark(1).checksum)] if scalar else None)
    recs.append(sorted(f"{mode}|{r.name}|{r.kind}|{r.lane}|{r.result}" for r in rep.records))
out["records"] = np.array(["\n".join(r) for r in recs])
np.savez(sys.argv[1], **out)
""" % (SLEEP,)


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """The JAX package's results over 8 forced host devices (one subprocess)."""
    pytest.importorskip("jax")
    path = tmp_path_factory.mktemp("fabric") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _JAX_FABRIC, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


# ------------------------------------------------------------------ views


@pytest.mark.parametrize("n_pods", [1, 2, 4])
def test_cluster_views_equal_jax(jx, n_pods):
    cl = SpatzformerCluster(n_pods=n_pods, devices=CPU8)
    mi, si = cl.merge_info(), cl.split_infos()
    row = [cl.n_devices, *cl.pod_shape, mi.n_devices, mi.data_size, mi.model_size, len(si),
           si[0].n_devices, si[0].data_size, si[0].model_size]
    if n_pods > 1:
        s = cl.surviving_cluster(0)
        row += [s.n_pods, s.n_devices, s.pod_info(0).n_devices, s.merge_info().data_size]
        # the survivors keep their lanes
        assert s.merged_mesh.lanes == cl.merged_mesh.lanes[cl.n_devices // n_pods:]
    assert row == jx[f"views{n_pods}"].tolist()
    assert cl.info_for(Mode.MERGE).mesh is cl.merged_mesh
    assert cl.info_for(Mode.SPLIT, n_pods - 1).mesh.lanes == list(cl._dev_grid[-1].flat)


def test_cluster_refusals_and_launch_views(jx):
    with pytest.raises(ValueError, match="not divisible"):
        SpatzformerCluster(n_pods=3, devices=CPU8)
    with pytest.raises(ValueError, match="pod_shape"):
        SpatzformerCluster(n_pods=2, pod_shape=(3, 1), devices=CPU8)
    for mode in ("split", "merge"):
        infos = serving_mesh_infos(mode, ["cpu"] * 4)
        got = [[i.n_devices, i.data_size, i.model_size] for i in infos]
        assert got == jx[f"serving_{mode}"].tolist()
    cl = SpatzformerCluster(n_pods=2, devices=CPU8)
    assert mesh_info_for(cl.merged_mesh).batch_axes == ("pod", "data")
    assert mesh_info_for(cl.pod_info(0).mesh).batch_axes == ("data",)


def test_coremark_checksums_equal_jax():
    pytest.importorskip("jax")
    from repro.core.coremark import coremark as jcoremark

    for iters, seed in COREMARK_CASES:
        got, want = coremark(iters, seed=seed), jcoremark(iters, seed=seed)
        assert (got.iterations, got.checksum) == (want.iterations, want.checksum)
    got = coremark(2, list_n=50, mat_dim=5, state_n=90, seed=9)
    assert got.checksum == jcoremark(2, list_n=50, mat_dim=5, state_n=90, seed=9).checksum


# ------------------------------------------------------------------ sync


@pytest.mark.parametrize("kernel", ["fft", "chain"])
@pytest.mark.parametrize("mode", ["merged", "split"])
def test_sync_harness_equals_jax(jx, kernel, mode):
    cl = SpatzformerCluster(n_pods=2, devices=CPU8)
    if kernel == "fft":
        k, x = fft2d_kernel(rounds=2), jx["x"]
    else:
        k = matmul_chain_kernel(torch.from_numpy(jx["w1"]), torch.from_numpy(jx["w2"]), rounds=2)
        x = jx["xr"]
    if mode == "merged":
        y, secs, program = run_merged(k, x, cl, repeats=1)
        assert callable(program)
    else:
        y, secs = run_split_staged(k, x, cl, repeats=1)
    assert secs > 0
    _close(y, jx[f"{kernel}_{mode}"])


def test_merged_program_stays_on_the_lanes():
    """The merged program takes and returns values sharded by rows over the
    fused lanes, and each round's corner turn is the transpose."""
    cl = SpatzformerCluster(n_pods=2, devices=CPU8)
    ident = lambda t: t * 1  # noqa: E731
    x = np.arange(256, dtype=np.float32).reshape(16, 16)
    y, _, program = run_merged(TwoPhaseKernel("t", ident, ident, 1), x, cl, repeats=1)
    np.testing.assert_array_equal(y, x)
    # a row-local phase after the first corner turn runs along x's columns
    y, _ = run_split_staged(TwoPhaseKernel("t", ident, lambda t: t.cumsum(-1), 1), x, cl,
                            repeats=1)
    np.testing.assert_array_equal(y, np.cumsum(x, axis=0))
    y, _, program = run_merged(TwoPhaseKernel("t", ident, lambda t: t.cumsum(-1), 1), x, cl,
                               repeats=1)
    np.testing.assert_array_equal(y, np.cumsum(x, axis=0))
    xd = device_put(torch.from_numpy(x), NamedSharding(
        Mesh(cl.merged_mesh.lanes, ("fab",)), P("fab", None)))
    out = program(xd)
    assert isinstance(out, ShardedTensor) and out.lanes == cl.merged_mesh.lanes
    assert all(s.shape == (2, 16) and s.is_contiguous() for s in out.shards)


# ------------------------------------------------------------------ reconfigure


def test_switch_mode_values_and_bytes_equal_jax(jx):
    one = SpatzformerCluster(n_pods=1, pod_shape=(1, 1), devices=["cpu"])
    w = torch.arange(12.0).reshape(3, 4)
    o, rep = switch_mode(one, Mode.MERGE, {"w": w})
    assert one.mode is Mode.MERGE and rep.from_desc == "split" and rep.to_desc == "merge"
    o2, rep2 = switch_mode(one, Mode.SPLIT, o)
    np.testing.assert_array_equal(gather(o2["w"]).numpy(), jx["switch34"])
    assert [rep.bytes_moved, rep2.bytes_moved] == jx["bytes34"].tolist() == [48, 48]
    # a shard already on its target lane is not copied
    assert o2["w"].shards[0] is o["w"].shards[0]
    _, rep3 = switch_mode(one, Mode.SPLIT)
    assert rep3.bytes_moved == 0 and rep3.gbytes_per_sec == 0


def test_switch_8x8_and_shrink_equal_jax(jx):
    cl = SpatzformerCluster(n_pods=2, devices=CPU8)
    si = cl.split_infos()
    x = torch.arange(64.0).reshape(8, 8)
    state = device_put({"w": x}, si[0].named(P("data", None)))
    assert [tuple(s.shape) for s in state["w"].shards] == [(4, 8)] * 4
    merged, rep = switch_mode(cl, Mode.MERGE, state)
    np.testing.assert_array_equal(gather(merged["w"]).numpy(), jx["switch88"])
    assert rep.bytes_moved == int(jx["bytes88"]) == 256
    assert merged["w"].sharding.spec == P() and merged["w"].lanes == cl.merged_mesh.lanes
    surv = cl.surviving_cluster(dead_pod=0)
    shrunk = reshard(merged, surv.pod_info(0))
    np.testing.assert_array_equal(gather(shrunk["w"]).numpy(), jx["shrunk88"])
    # the survivors' lanes already held the replicated block: kept, not copied
    assert all(a is b for a, b in zip(shrunk["w"].shards, merged["w"].shards[4:]))


def test_device_put_gather_constraint_round_trips():
    cl = SpatzformerCluster(n_pods=2, devices=CPU8)
    info = cl.merge_info()
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    specs = [P(), P(("pod", "data")), P(None, "model"), P(("pod", "data"), None, "model"),
             P("model", "data"), P(None, None, ("pod", "model"))]
    v = device_put(x, info.named(specs[0]))
    for spec in specs[1:] + specs[:1]:
        w = info.constraint(v, spec)
        assert torch.equal(gather(w), x) and w.sharding.spec == spec
        for lane, blk, t in zip(w.lanes, w.sharding.blocks(x.shape), w.shards):
            assert t.is_contiguous() and torch.equal(t, x[tuple(slice(*b) for b in blk)])
        v = w
    with pytest.raises(ValueError, match="does not divide"):
        device_put(torch.zeros(3, 4), info.named(P("pod")))
    with pytest.raises(ValueError, match="not in"):
        device_put(torch.zeros(4, 4), info.named(P("fab")))
    # a tree of shardings, numpy leaves, the batch spec
    tree = device_put({"a": np.ones((4, 2), np.float32), "b": [torch.zeros(2)]},
                      {"a": info.named(info.batch_spec(2)), "b": [info.named(P())]})
    assert tree["a"].sharding.spec == P(("pod", "data"), None)
    assert torch.equal(gather(tree["b"][0]), torch.zeros(2))
    shardings = param_shardings({"w": torch.empty(256, 512, device="meta")}, info)
    assert shardings["w"].spec == P(None, "model")


# ------------------------------------------------------------------ scheduler


def test_scheduler_records_equal_jax(jx):
    """The records of all three paths equal JAX's, and the concurrency each
    path promises holds, shown by barriers rather than wall-clock bounds:
    in MERGE the first vector task and the scalar task meet at a barrier
    (both in flight at once, so their intervals intersect); two tenants'
    first tasks meet at one too (the pods run at once)."""
    cl = SpatzformerCluster(n_pods=2, devices=CPU8)
    sched = MixedScheduler(cl)
    meet = {}  # the barrier of the current run, keyed by the task that waits on it

    def vec_task(name):
        def vec(info):
            if name in meet:
                meet[name].wait()  # raises BrokenBarrierError unless its partner arrives
            time.sleep(SLEEP)
            return info.n_devices

        return VectorTask(name, vec)

    def checksum():
        if "cm" in meet:
            meet["cm"].wait()
        return coremark(1).checksum

    got = []
    for mode, nv, scalar in ((Mode.MERGE, 3, True), (Mode.SPLIT, 3, True),
                             (Mode.SPLIT, 4, False)):
        barrier = threading.Barrier(2, timeout=60)
        meet.clear()
        if mode is Mode.MERGE:
            meet.update(v0=barrier, cm=barrier)
        elif not scalar:  # v0 and v1: the round-robin's first task on each pod
            meet.update(v0=barrier, v1=barrier)
        rep = sched.run(mode, [vec_task(f"v{i}") for i in range(nv)],
                        [ScalarTask("cm", checksum)] if scalar else None)
        got.append("\n".join(sorted(f"{mode}|{r.name}|{r.kind}|{r.lane}|{r.result}"
                                    for r in rep.records)))
        if mode is Mode.MERGE:
            # the scalar task and the first vector task were in flight together
            v0 = next(r for r in rep.records if r.name == "v0")
            cm = next(r for r in rep.records if r.kind == "scalar")
            assert cm.start < v0.end and v0.start < cm.end
            assert rep.lane_time("ctl0/merged") >= 3 * SLEEP
            assert rep.kind_time("vector") >= 3 * SLEEP and "ctl1/freed" in rep.summary()
        if not scalar:  # two tenants at once: each pod's first task met the other's
            assert {r.lane for r in rep.records} == {"ctl0/pod0", "ctl1/pod1"}
    assert got == jx["records"].tolist()


def test_scheduler_reraises_a_task_error():
    sched = MixedScheduler(SpatzformerCluster(n_pods=2, devices=CPU8))

    def bad(info):
        raise RuntimeError("task failed")

    with pytest.raises(RuntimeError, match="task failed"):
        sched.run(Mode.SPLIT, [VectorTask("bad", bad)])


# ------------------------------------------------------------------ collectives


def test_ring_matmuls_equal_jax(jx):
    lanes = lanes_for(["cpu"] * 4)
    mesh = Mesh(lanes, ("model",))
    a, w = torch.from_numpy(jx["a"]), torch.from_numpy(jx["wm"])
    ref = jx["a"] @ jx["wm"]
    rs = ring_rs_matmul(device_put(a, NamedSharding(mesh, P(None, "model"))),
                        device_put(w, NamedSharding(mesh, P("model", None))), "model")
    assert rs.sharding.spec == P("model", None)
    _close(gather(rs).numpy(), ref, RING_RTOL)
    _close(gather(rs).numpy(), jx["rs"], RING_RTOL)
    ag = ring_ag_matmul(device_put(a, NamedSharding(mesh, P("model", None))),
                        device_put(w, NamedSharding(mesh, P(None, "model"))), "model")
    assert ag.sharding.spec == P(None, "model")
    _close(gather(ag).numpy(), ref, RING_RTOL)
    _close(gather(ag).numpy(), jx["ag"], RING_RTOL)
    with pytest.raises(ValueError, match="needs x"):
        ring_rs_matmul(device_put(a, NamedSharding(mesh, P("model", None))),
                       device_put(w, NamedSharding(mesh, P("model", None))), "model")


@pytest.mark.parametrize("p", [1, 2, 8])
def test_ring_matmuls_over_rings_of_a_mesh(p):
    """Rings along one axis of a 2-D mesh (one ring per row of lanes), and
    a ring of one."""
    rng = np.random.default_rng(p)
    a = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32))
    mesh = Mesh(np.array(lanes_for(["cpu"] * 8), dtype=object).reshape(8 // p, p),
                ("data", "model"))
    ref = (a @ w).numpy()
    rs = ring_rs_matmul(device_put(a, NamedSharding(mesh, P("data", "model"))),
                        device_put(w, NamedSharding(mesh, P("model", None))), "model")
    assert rs.sharding.spec == P(("data", "model"), None)
    _close(gather(rs).numpy(), ref, RING_RTOL)
    ag = ring_ag_matmul(device_put(a, NamedSharding(mesh, P("model", None))),
                        device_put(w, NamedSharding(mesh, P(None, ("data", "model")))), "model")
    _close(gather(ag).numpy(), ref, RING_RTOL)


def test_no_module_of_the_port_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    new = {"dist/sharding.py", "dist/collectives.py", "core/cluster.py", "core/coremark.py",
           "core/reconfigure.py", "core/scheduler.py", "core/sync.py", "launch/mesh.py"}
    assert new <= {f.relative_to(ROOT / "src" / "repro_torch").as_posix() for f in files}
    for f in files:
        roots = set()
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert not roots & {"jax", "jaxlib", "repro"}, f


# ------------------------------------------------------------------ the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_lanes_on_one_card_have_streams_of_their_own():
    dev = _card()
    cl = SpatzformerCluster(n_pods=2, devices=[dev, dev])
    a, b = cl.merged_mesh.lanes
    assert a.device == b.device == dev
    assert a.stream is not None and b.stream is not None
    assert a.stream != b.stream and torch.cuda.current_stream(dev) not in (a.stream, b.stream)
    with a.use():
        assert torch.cuda.current_stream(dev) == a.stream
    x = torch.randn(64, 32, device=dev)
    v = device_put(x, cl.merge_info().named(P(("pod", "data"))))
    assert torch.equal(gather(v), x)


@pytest.mark.cuda
def test_cuda_merged_run_makes_no_host_copy_between_rounds():
    dev = _card()
    cl = SpatzformerCluster(n_pods=2, devices=[dev, dev])
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((256, 256)) + 1j * rng.standard_normal((256, 256))).astype(
        np.complex64)
    y, _, program = run_merged(fft2d_kernel(rounds=3), x, cl, repeats=1)
    ref, _, _ = run_merged(fft2d_kernel(rounds=3), x, SpatzformerCluster(
        n_pods=2, devices=["cpu", "cpu"]), repeats=1)
    _close(y, ref)
    xd = device_put(torch.from_numpy(x), NamedSharding(
        Mesh(cl.merged_mesh.lanes, ("fab",)), P("fab", None)))
    cl.merged_mesh.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("merged_rounds"):
            program(xd)
    cl.merged_mesh.synchronize()
    events = prof.events()
    # the profiler synchronizes the device itself when it stops, after the span
    span = next(e.time_range for e in events if e.name == "merged_rounds")
    inside = [e.name for e in events if span.start <= e.time_range.start <= span.end]
    assert not [n for n in inside if "_local_scalar_dense" in n or "Synchronize" in n], inside
    assert not [e.name for e in events if "DtoH" in e.name or "Device -> Host" in e.name]
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in events)


@pytest.mark.cuda
def test_cuda_ring_matmuls_and_switch_on_one_card():
    dev = _card()
    lanes = lanes_for([dev] * 2)
    mesh = Mesh(lanes, ("model",))
    a = torch.randn(256, 512, device=dev)
    w = torch.randn(512, 128, device=dev)
    ref = (a.cpu() @ w.cpu()).numpy()
    rs = ring_rs_matmul(device_put(a, NamedSharding(mesh, P(None, "model"))),
                        device_put(w, NamedSharding(mesh, P("model", None))), "model")
    _close(gather(rs, "cpu").numpy(), ref, RING_RTOL)
    ag = ring_ag_matmul(device_put(a, NamedSharding(mesh, P("model", None))),
                        device_put(w, NamedSharding(mesh, P(None, "model"))), "model")
    _close(gather(ag, "cpu").numpy(), ref, RING_RTOL)
    cl = SpatzformerCluster(n_pods=2, pod_shape=(1, 2), devices=[dev] * 4)
    state = {"w": torch.randn(512, 256, device=dev)}
    s0 = device_put(state, param_shardings(state, cl.pod_info(0)))
    s1, rep = switch_mode(cl, Mode.MERGE, s0)
    assert all(a is b for a, b in zip(s1["w"].shards, s0["w"].shards))
    assert rep.bytes_moved == 512 * 256 * 4
    assert torch.equal(gather(s1["w"]), state["w"])


@pytest.mark.cuda
def test_cuda_first_launch_from_a_controller_thread():
    """A scheduler's controller thread whose first CUDA work is a
    hand-written kernel, its output served from the caching allocator (no
    cudaMalloc there to bind a context), in every path; the caller's
    current device is left as it was."""
    from repro_torch.kernels import ops

    dev = _card()
    a = torch.randn(256, 512, device=dev, dtype=torch.bfloat16)
    b = torch.randn(512, 256, device=dev, dtype=torch.bfloat16)
    want = ops.matmul(a, b)
    torch.cuda.synchronize()
    before = torch.cuda.current_device()
    sched = MixedScheduler(SpatzformerCluster(n_pods=2, devices=[dev, dev]))
    for mode, scalar in ((Mode.MERGE, True), (Mode.SPLIT, True), (Mode.SPLIT, False)):
        rep = sched.run(mode, [VectorTask(f"v{i}", lambda info: ops.matmul(a, b))
                               for i in range(2)],
                        [ScalarTask("s", lambda: coremark(5))] if scalar else None)
        for r in rep.records:
            if r.kind == "vector":
                assert torch.equal(r.result, want), (mode, r.lane)
    assert torch.cuda.current_device() == before


@pytest.mark.cuda
def test_cuda_launch_on_a_second_device_keeps_the_current_device():
    """A kernel launched on a second card's lane, from the caller's thread
    and from a controller thread, leaves the caller's current device as it
    was (binding a context is the controller thread's own business)."""
    from repro_torch.kernels import ops

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    a = torch.randn(256, 512, device=dev, dtype=torch.bfloat16)
    b = torch.randn(512, 256, device=dev, dtype=torch.bfloat16)
    lane = lanes_for([dev])[0]
    with lane.use():
        got = ops.matmul(a, b)
    lane.synchronize()
    assert torch.cuda.current_device() == 0
    rep = MixedScheduler(SpatzformerCluster(n_pods=1, pod_shape=(1, 1), devices=[dev])).run(
        Mode.MERGE, [VectorTask("v", lambda info: ops.matmul(a, b))])
    assert torch.equal(rep.records[0].result, got)
    assert torch.cuda.current_device() == 0
    ref = (a.float().cpu() @ b.float().cpu())
    assert torch.allclose(got.float().cpu(), ref, rtol=2e-2, atol=2e-2 * float(ref.abs().max()))
