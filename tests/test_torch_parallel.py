"""The port's multi-device trainer against the JAX package's, on the CPU:
the (1, 1) mesh's sharded step (parallel/sharded.py) against the JAX
sharded step, the refine pass over shards (parallel/trainer.
make_sharded_refine_step) against the single-device refine, and the
process group's setup (parallel/mesh.py); the bands and the balanced
windows are in tests/test_torch_parallel_windows.py.

The port's ranks run as gloo processes (tests/torch_ranks.run_ranks, one
torch thread each); the JAX sharded step runs here on conftest's virtual
CPU devices with impl="pallas" in interpret mode, as tests/
test_sharded.py runs it. This module also holds the helpers of
test_torch_parallel_model.py and test_torch_parallel_data.py.

Tolerances: a sharded step as tests/test_sharded.py holds the
JAX sharded step against its single-device one (loss rtol 1e-5,
parameters and statistics atol 1e-5), parameters compared where the
reference's gradient is above tests/test_torch_train_step.py's floor and
bounded by 2 lr elsewhere; the refine over shards bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.engine.scene_train_step import (
    init_scene_train_state as j_init_state)
from street_gaussians_ns_tpu.ops.render import RenderConfig as JRenderConfig
from street_gaussians_ns_tpu.parallel.mesh import make_mesh as j_make_mesh
from street_gaussians_ns_tpu.parallel.sharded import (
    make_sharded_train_step as j_make_step, stack_batches as j_stack_batches,
    stack_cameras as j_stack_cameras)
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.engine import optimizers as topt
from street_gaussians_ns_tpu_torch.engine import scene_train_step as tsts
from street_gaussians_ns_tpu_torch.engine.train_step import GAUSSIAN_GROUPS
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig
from street_gaussians_ns_tpu_torch.parallel import collectives, mesh as tmesh

from test_scene_graph import CFG, H, W, make_store, make_tracks
from test_sharded import make_cameras
from test_torch_scene_graph import port_config, store_arrays
from torch_ranks import run_ranks

GRAD_TOL = 2e-5       # of the group's largest |g|, as test_torch_train_step
STEP = 40             # a refine step of CFG (past warmup, densifying)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The sharded step on both sides.
# ---------------------------------------------------------------------------

def _anisotropic(store):
    """Anisotropic scales: with the initial isotropic ones the quaternions'
    gradient is pure rounding (tests/test_torch_train_step.py)."""
    rng = np.random.default_rng(1)

    def aniso(part):
        s = part.params.scales
        return dataclasses.replace(part, params=dataclasses.replace(
            part.params, scales=s + jnp.asarray(
                0.4 * rng.standard_normal(s.shape), jnp.float32)))

    return dataclasses.replace(store, background=aniso(store.background),
                               objects=aniso(store.objects))


def _saturating(store):
    """Opaque (sigmoid(5) = 0.993), larger background gaussians: most
    pixels end before the far end of the depth order."""
    p = store.background.params
    return dataclasses.replace(store, background=dataclasses.replace(
        store.background, params=dataclasses.replace(
            p, opacities=jnp.full_like(p.opacities, 5.0),
            scales=p.scales + 1.0)))


def jax_sharded(data, model, precision="f32", sky=True, subset_accs=False,
                seed=0, run=True, saturate=False):
    """One JAX sharded step on a (data, model) mesh of the virtual CPU
    devices, from test_scene_graph's store at step STEP - 1 (saturate:
    made opaque, _saturating), each data row its own camera and random
    target. Returns what port_sharded needs and the JAX results (only the
    inputs with run=False)."""
    cfg = CFG if sky else dataclasses.replace(CFG, base=dataclasses.replace(
        CFG.base, use_sky_sphere=False))
    store = _anisotropic(make_store(seed))
    if saturate:
        store = _saturating(store)
    if not sky:
        store = dataclasses.replace(store, env_map=None)
    tracks = make_tracks()
    jstate = dataclasses.replace(
        j_init_state(store, jax.random.PRNGKey(seed)),
        step=jnp.int32(STEP - 1))
    cams = make_cameras(data)
    rng = np.random.default_rng(seed)
    batches = [{"image": rng.random((H, W, 3), dtype=np.float32)}
               for _ in range(data)]
    rcfg = JRenderConfig(max_pairs=16384, impl="pallas", interpret=True,
                         precision=precision)
    cam_b, batch_b = j_stack_cameras(cams), j_stack_batches(batches, H, W)
    jnew, jm = jstate, {}
    if run:
        mesh = j_make_mesh(data=data, model=model)
        step = j_make_step(mesh, cfg, rcfg, W, H,
                           cap_bg=store.background.capacity,
                           subset_accs=subset_accs)
        with jax.set_mesh(mesh):
            jnew, jm = step(jstate, tracks, cam_b, batch_b)
    keys = jax.random.split(jstate.rng, data + 1)[1:]
    jitters = (np.stack([np.asarray(jax.random.uniform(k, (2, H, W),
                                                        jnp.float32))
                         for k in keys]) if sky else None)
    return dict(data=data, model=model, precision=precision,
                subset_accs=subset_accs, cfg=port_config(cfg),
                state=store_arrays(jstate), tracks=store_arrays(tracks),
                cam_b={k: np.asarray(v) for k, v in cam_b.items()},
                batch_b={k: np.asarray(v) for k, v in batch_b.items()},
                jitters=jitters, new=store_arrays(jnew),
                metrics={k: float(v) for k, v in jm.items()})


def sharded_job(want, refine=None):
    """The launch job of the port's ranks for jax_sharded's inputs: one
    run of one step."""
    return dict(
        state=want["state"], tracks=want["tracks"], config=want["cfg"],
        backend="gloo", device="cpu", cam_b=want["cam_b"],
        batch_b=want["batch_b"],
        jitters=None if want["jitters"] is None else want["jitters"][None],
        width=W, height=H, step=STEP - 1, subset_accs=want["subset_accs"],
        seed=0, runs=[dict(data=want["data"], model=want["model"], steps=1,
                           refine=refine, render_config=RenderConfig(
                               max_pairs=16384,
                               precision=want["precision"]))])


def port_sharded(want, workdir):
    ranks = [r["runs"][0] for r in run_ranks(
        sharded_job(want), want["data"] * want["model"], workdir)]
    return dict(ranks=ranks, metrics=ranks[0]["metrics"][0],
                state=ranks[0]["state"])


def assert_same_step(got, want, loss_rtol=1e-5):
    """A port sharded step against the JAX one (module docstring)."""
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=loss_rtol)
    for k in ("psnr",):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-5, err_msg=k)
    assert got["metrics"]["gaussian_count"] == want["metrics"][
        "gaussian_count"]
    # Every rank holds the same state after the step.
    for r in got["ranks"][1:]:
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, got["state"][k], err_msg=k)
    old, new, ts = want["state"], want["new"], got["state"]
    groups = [(f"{n}/{k}", f"store/{part}/params/{n}", f"opt/{n}/mu/{k}",
               topt.DEFAULT_GROUPS[n])
              for n in GAUSSIAN_GROUPS
              for k, part in (("bg", "background"), ("obj", "objects"))]
    if "store/env_map" in new:
        groups.append(("sky", "store/env_map", "opt/sky_sphere/mu",
                       topt.DEFAULT_GROUPS["sky_sphere"]))
    for name, pkey, mukey, gcfg in groups:
        jg = new[mukey] / 0.1              # first step from zero moments
        lr = topt.schedule(gcfg, STEP - 1)
        floor = GRAD_TOL * float(np.abs(jg).max())
        sure = np.abs(jg) > floor
        if not sure.any():                 # features_rest at SH degree 0
            np.testing.assert_array_equal(ts[pkey], new[pkey], err_msg=name)
            continue
        np.testing.assert_allclose(ts[pkey][sure], new[pkey][sure], rtol=0,
                                   atol=1e-5, err_msg=name)
        assert float(np.abs(ts[pkey] - old[pkey]).max()) <= 2 * lr * 1.001, \
            name
    for part in ("background", "objects"):
        np.testing.assert_array_equal(ts[f"store/{part}/vis_counts"],
                                      new[f"store/{part}/vis_counts"])
        for k in ("max_2dsize", "xys_grad_norm"):
            np.testing.assert_allclose(ts[f"store/{part}/{k}"],
                                       new[f"store/{part}/{k}"], rtol=0,
                                       atol=1e-5, err_msg=k)
    assert int(ts["step"]) == int(new["step"]) == STEP


def test_unit_mesh_matches_jax(tmp_path):
    """The (1, 1) mesh: one rank, no collective, the JAX (1, 1) sharded
    step with the subset accumulations live."""
    want = jax_sharded(1, 1, subset_accs=True)
    got = port_sharded(want, tmp_path)
    assert_same_step(got, want)


def test_refine_over_shards_equals_single_device_refine(tmp_path):
    """make_sharded_refine_step on a (1, 2) mesh (gather, the same refine
    on both ranks, keep the local rows) after one step: the gathered state
    equals scene_refine_step on the full stepped state, bit for bit, and
    the refine densified and culled."""
    want = jax_sharded(1, 2, sky=False, run=False)
    ranks = [r["runs"][0] for r in run_ranks(sharded_job(want, refine=2), 2,
                                             tmp_path / "refined")]
    stepped = run_ranks(sharded_job(want), 2, tmp_path / "stepped")
    cfg = want["cfg"]
    state = tckpt.train_state_from_numpy(stepped[0]["runs"][0]["state"], cfg,
                                         device="cpu", seed=0)
    ref, info = tsts.scene_refine_step(state, cfg, 2, max(W, H))
    ref = tckpt.state_to_numpy(ref)
    for r in ranks:
        assert set(r["state"]) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
    act0 = want["state"]["store/background/active"].sum()
    assert int(ref["store/background/active"].sum()) != int(act0)


# ---------------------------------------------------------------------------
# The process group.
# ---------------------------------------------------------------------------

def test_world_of_one_mesh_and_failed_init_raises():
    """A world of one process starts its own group; make_mesh lays it out
    as (1, 1) with no group calls; a rank whose coordinator never answers
    raises instead of running alone."""
    import torch.distributed as dist

    tmesh.multihost_init(backend="gloo")
    try:
        m = tmesh.make_mesh(device="cpu")
        assert (m.data, m.model, m.row, m.col) == (1, 1, 0, 0)
        x = torch.arange(4.0)
        assert collectives.all_gather_tiled(x, m.model_group) is x
        with pytest.raises(ValueError, match="world size"):
            tmesh.make_mesh(data=2, device="cpu")
    finally:
        dist.destroy_process_group()
    with pytest.raises(Exception):
        tmesh.multihost_init(f"127.0.0.1:{tmesh.free_port()}", 2, 1,
                             backend="gloo", timeout_s=2.0)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="backend"):
        tmesh.multihost_init(backend="mpi")


def test_init_on_another_backend_raises():
    """multihost_init on a group already initialised with another backend
    (or as another rank) raises instead of carrying on; the same call is
    accepted."""
    import torch.distributed as dist

    tmesh.multihost_init(backend="gloo")
    try:
        tmesh.multihost_init(backend="gloo")
        with pytest.raises(RuntimeError, match="on gloo, asked .* on nccl"):
            tmesh.multihost_init(backend="nccl")
        with pytest.raises(RuntimeError, match="rank 1 of 2"):
            tmesh.multihost_init("127.0.0.1:1", 2, 1, backend="gloo")
    finally:
        dist.destroy_process_group()

