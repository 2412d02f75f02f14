"""The port's single-model Splatfacto pipeline (models/splatfacto.forward,
engine/train_step.train_step and refine_step) against the JAX package's,
on the CPU, from the same numpy store, batch, sky jitter and split noise.

The cloud: 500 slots, 420 active, SH degree 1, Fourier dim 3 read at
time 0.4 with fourier_features_scale 0.5, anisotropic scales, a textured
16x16 sky cubemap, 64x48 cameras. The JAX side renders with
impl="chunked" (its per-tile budget asserted to truncate nothing).

Tolerances, those of the scene-graph tests these mirror
(tests/test_torch_scene_graph.py, tests/test_torch_train_step.py,
tests/test_torch_refinement.py):
- forward heads: rgb / accumulation / sky at atol 2e-5, depth at rtol
  1e-4 where the accumulation > 1e-3;
- a step's loss and metrics at atol 2e-5 / rtol 1e-5; every group's
  first moment (0.1 g) at 2e-5 of its largest |g| and its parameters at
  1e-3 of lr where |g| is above that floor; the densification counts
  exact, the accumulated gradient norm at the gradient tolerance;
- a second step from the JAX state after the first, so both start from
  the same moments: parameters at rtol 1e-6 / atol 1e-3 lr where the
  reference's update is clear of rounding, moments at rtol 1e-5;
- refine_step from the same state and split noise: counts, active mask
  and keep mask exact, parameters at rtol 1e-6 (atol 1e-6 on means and
  scales), moments exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.core.cameras import Camera as JCamera
from street_gaussians_ns_tpu.engine import train_step as jts
from street_gaussians_ns_tpu.models import gaussians as jgauss
from street_gaussians_ns_tpu.models import splatfacto as jsplat
from street_gaussians_ns_tpu.ops.render import RenderConfig as JRenderConfig
from street_gaussians_ns_tpu_torch.core.cameras import Camera as TCamera
from street_gaussians_ns_tpu_torch.engine import optimizers as topt
from street_gaussians_ns_tpu_torch.engine import train_step as tts
from street_gaussians_ns_tpu_torch.models import gaussians as tgauss
from street_gaussians_ns_tpu_torch.models import refinement as tref
from street_gaussians_ns_tpu_torch.models import splatfacto as tsplat
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig

from test_torch_render import assert_heads_close

W, H = 64, 48
CAP, N_ACTIVE = 500, 420
MAX_PAIRS = 16384
STEP0 = 599            # two steps, then the refine pass at step 600
GRAD_TOL = 2e-5
PARAMS = tts.GAUSSIAN_GROUPS
STATS = ("xys_grad_norm", "vis_counts", "max_2dsize")
# sh_degree_interval 100: SH degree 1 is live at STEP0 (features_rest
# trains).
JCFG = jsplat.SplatfactoConfig(sh_degree=1, sh_degree_interval=100,
                               env_map_res=16, fourier_features_dim=3,
                               fourier_features_scale=0.5)
CFG = tsplat.SplatfactoConfig(**dataclasses.asdict(JCFG))
TIME = 0.4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x))


def _arrays(seed=0) -> dict:
    """A cloud in front of the camera, numpy, keyed as a store's leaves."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xy = rng.uniform(-2.5, 2.5, (CAP, 2))
    z = rng.uniform(-9.0, -4.0, (CAP, 1))
    q = rng.standard_normal((CAP, 4))
    op = rng.uniform(0.1, 0.9, (CAP, 1))
    active = np.zeros(CAP, bool)
    active[rng.permutation(CAP)[:N_ACTIVE]] = True
    return {
        "params/means": np.concatenate([xy, z], 1).astype(f32),
        "params/scales": (rng.standard_normal((CAP, 3)) * 0.4 - 2.3
                          ).astype(f32),
        "params/quats": (q / np.linalg.norm(q, axis=1, keepdims=True)
                         ).astype(f32),
        "params/features_dc": rng.standard_normal((CAP, 3, 3)).astype(f32),
        "params/features_rest": (0.3 * rng.standard_normal((CAP, 3, 3))
                                 ).astype(f32),
        "params/opacities": np.log(op / (1 - op)).astype(f32),
        "active": active,
        **{k: np.zeros(CAP, f32) for k in STATS},
        "env_map": rng.random((6, 16, 16, 3), dtype=f32),
    }


def _jax_store(a):
    return jgauss.GaussianStore(
        params=jgauss.GaussianParams(**{
            k: jnp.asarray(a[f"params/{k}"]) for k in PARAMS}),
        active=jnp.asarray(a["active"]),
        **{k: jnp.asarray(a[k]) for k in STATS})


def _port_store(a):
    return tgauss.GaussianStore(
        params=tgauss.GaussianParams(**{
            k: T(a[f"params/{k}"]) for k in PARAMS}),
        active=T(a["active"]), **{k: T(a[k]) for k in STATS})


def _store_np(store) -> dict:
    out = {f"params/{k}": np.asarray(getattr(store.params, k))
           for k in PARAMS}
    out.update({k: np.asarray(getattr(store, k)) for k in STATS + ("active",)})
    return out


def _port_state(jstate, seed=0) -> tts.TrainState:
    """The JAX TrainState's arrays as the port's TrainState."""
    a = _store_np(jstate.store)
    opt = {name: topt.AdamState(mu=T(s.mu), nu=T(s.nu), count=int(s.count))
           for name, s in jstate.opt.items()}
    return tts.TrainState(store=_port_store(a), env_map=T(jstate.env_map),
                          opt=opt, step=int(jstate.step),
                          generator=torch.Generator().manual_seed(seed))


def _cameras():
    c2w = np.eye(3, 4, dtype=np.float32)
    jc = JCamera.make(60.0, 60.0, 32.0, 24.0, jnp.asarray(c2w), W, H,
                      time=TIME)
    tc = TCamera.make(60.0, 60.0, 32.0, 24.0, c2w, W, H, time=TIME,
                      device="cpu")
    return jc, tc


JR = JRenderConfig(max_pairs=MAX_PAIRS, max_per_tile=1024, chunk=32,
                   impl="chunked")
RCFG = RenderConfig(max_pairs=MAX_PAIRS)
DEPTH_OF = {"depth": "accumulation"}


@pytest.mark.parametrize("training", [False, True])
def test_forward_matches_jax(training):
    a = _arrays()
    jc, tc = _cameras()
    key = jax.random.PRNGKey(3)
    jout, jr = jax.jit(jsplat.forward,
                       static_argnames=("config", "render_config",
                                        "training"))(
        _jax_store(a).params, jnp.asarray(a["active"]), jc, jnp.int32(1500),
        config=JCFG, render_config=JR, env_map=jnp.asarray(a["env_map"]),
        rng=key, training=training, time=jnp.float32(TIME))
    assert int(jr.bins.max_tile_count) <= 1024
    jitter = T(np.asarray(jax.random.uniform(key, (2, H, W), jnp.float32)))
    store = _port_store(a)
    tout, tr = tsplat.forward(store.params, store.active, tc, 1500, CFG,
                              RCFG, env_map=T(a["env_map"]), jitter=jitter,
                              training=training, time=TIME)
    assert set(tout) == set(jout) == {"rgb", "accumulation", "depth", "sky"}
    assert_heads_close(tout, jout, DEPTH_OF)
    np.testing.assert_array_equal(tr.projected.radii.numpy(),
                                  np.asarray(jr.projected.radii))
    assert float(tout["accumulation"].max()) > 0.5
    # Without a sky the background is black; the time moves the colours.
    bare, _ = tsplat.forward(store.params, store.active, tc, 1500, CFG,
                             RCFG, training=training, time=TIME)
    assert "sky" not in bare
    assert torch.equal(bare["accumulation"], tout["accumulation"])
    other, _ = tsplat.forward(store.params, store.active, tc, 1500, CFG,
                              RCFG, training=training, time=0.0)
    assert float((other["rgb"] - bare["rgb"]).abs().max()) > 1e-3


@pytest.fixture(scope="module")
def steps():
    """Two JAX train steps from STEP0; the port's first step from the
    same state, its second from the JAX state after the first."""
    a = _arrays()
    jc, tc = _cameras()
    rng = np.random.default_rng(1)
    batch = {"image": rng.random((H, W, 3), dtype=np.float32),
             "semantic": rng.integers(0, 4, (H, W, 1)).astype(np.int32),
             "time": np.float32(TIME)}
    j0 = dataclasses.replace(
        jts.init_train_state(_jax_store(a), jnp.asarray(a["env_map"]),
                             jax.random.PRNGKey(5)),
        step=jnp.int32(STEP0))
    jstep = jax.jit(jts.train_step,
                    static_argnames=("config", "render_config"))
    j1, jm1 = jstep(j0, jc, batch, config=JCFG, render_config=JR)
    j2, jm2 = jstep(j1, jc, batch, config=JCFG, render_config=JR)
    assert int(jm1["max_tile_count"]) <= 1024

    def jitter(jstate):
        k = jax.random.split(jstate.rng)[1]
        return T(np.asarray(jax.random.uniform(k, (2, H, W), jnp.float32)))

    tbatch = {k: T(v) for k, v in batch.items()}
    t0 = _port_state(j0)
    t1, tm1 = tts.train_step(t0, tc, tbatch, CFG, RCFG, jitter=jitter(j0))
    t2, tm2 = tts.train_step(_port_state(j1), tc, tbatch, CFG, RCFG,
                             jitter=jitter(j1))
    return dict(j0=j0, j1=j1, j2=j2, jm1=jm1, jm2=jm2, t0=t0, t1=t1, t2=t2,
                tm1=tm1, tm2=tm2, tc=tc, batch=tbatch)


def test_train_step_metrics_match_jax(steps):
    for tm, jm in ((steps["tm1"], steps["jm1"]), (steps["tm2"], steps["jm2"])):
        assert set(tm) == set(jm) == {
            "loss", "psnr", "gaussian_count", "num_pairs", "num_rowruns",
            "max_tile_count", "Ll1", "simloss", "sky_accumulation"}
        for k in set(jm) - {"num_rowruns"}:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=2e-5, err_msg=k)
        # The portable binning counts untrimmed tile rows.
        assert 0 < int(tm["num_rowruns"]) <= int(jm["num_rowruns"])
    assert steps["t1"].step == STEP0 + 1 and steps["t0"].step == STEP0
    assert steps["t2"].step == STEP0 + 2


def _leaves(tstate, jstate, start):
    for n in PARAMS:
        yield (n, getattr(tstate.store.params, n),
               getattr(jstate.store.params, n),
               getattr(start.store.params, n), tstate.opt[n], jstate.opt[n],
               topt.schedule(topt.DEFAULT_GROUPS[n], int(start.step)))
    yield ("sky_sphere", tstate.env_map, jstate.env_map, start.env_map,
           tstate.opt["sky_sphere"], jstate.opt["sky_sphere"],
           topt.schedule(topt.DEFAULT_GROUPS["sky_sphere"], int(start.step)))


def test_first_step_groups_match_jax(steps):
    """Seven groups from zero moments: mu = 0.1 g."""
    t1, j1, j0 = steps["t1"], steps["j1"], steps["j0"]
    assert set(t1.opt) == set(j1.opt) == set(PARAMS) | {"sky_sphere"}
    for name, tp, jp, p0, ts, js, lr in _leaves(t1, j1, j0):
        jmu = np.asarray(js.mu)
        top = float(np.abs(jmu).max())
        assert top > 0, name
        np.testing.assert_allclose(ts.mu.numpy(), jmu, rtol=0,
                                   atol=GRAD_TOL * top, err_msg=name)
        sure = np.abs(jmu) > GRAD_TOL * top
        np.testing.assert_allclose(tp.numpy()[sure], np.asarray(jp)[sure],
                                   rtol=1e-6, atol=1e-3 * lr, err_msg=name)
        assert float(np.abs(tp.numpy() - np.asarray(p0)).max()) \
            <= 2 * lr * 1.001, name
        assert ts.count == int(js.count) == 1
    st, sj = steps["t1"].store, steps["j1"].store
    for k in ("vis_counts", "max_2dsize"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(sj, k)), err_msg=k)
    top = float(np.asarray(sj.xys_grad_norm).max())
    assert top > 0 and int(st.vis_counts.sum()) > 100
    np.testing.assert_allclose(st.xys_grad_norm.numpy(),
                               np.asarray(sj.xys_grad_norm), rtol=0,
                               atol=2 * GRAD_TOL * top)


def test_second_step_matches_jax(steps):
    """From the same carried moments (count 1 -> 2)."""
    t2, j2, j1 = steps["t2"], steps["j2"], steps["j1"]
    for name, tp, jp, p0, ts, js, lr in _leaves(t2, j2, j1):
        jp, p0 = np.asarray(jp), np.asarray(p0)
        upd = np.abs(jp - p0)
        sure = upd > 0.05 * lr
        assert sure.any(), name
        np.testing.assert_allclose(tp.numpy()[sure], jp[sure], rtol=1e-6,
                                   atol=1e-3 * lr, err_msg=name)
        top = float(np.abs(np.asarray(js.mu)).max())
        np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu),
                                   rtol=1e-5, atol=GRAD_TOL * top,
                                   err_msg=name)
        assert ts.count == int(js.count) == 2


def test_refine_step_matches_jax(steps):
    """The refine pass at step 600 (past warmup: densify) from the JAX
    state after two steps, with the JAX package's split noise."""
    j2 = steps["j2"]
    jnew, jinfo = jax.jit(jts.refine_step,
                          static_argnames=("config", "num_train_data"))(
        j2, config=JCFG, num_train_data=3, max_hw=jnp.int32(64))
    k = jax.random.split(j2.rng)[1]
    capp = tref.parent_budget(CFG, CAP)
    noise = T(np.asarray(jax.random.normal(jax.random.split(k, 1)[0],
                                           (CFG.n_split_samples, capp, 3),
                                           jnp.float32)))
    start = _port_state(j2)
    tnew, tinfo = tts.refine_step(start, CFG, 3, 64, noise=noise)
    assert set(tinfo) == set(jinfo)
    for key in jinfo:
        assert int(tinfo[key]) == int(jinfo[key]), key
    assert int(tinfo["refine_splits_count"]) + int(
        tinfo["refine_dups_count"]) > 0
    got, want = tnew.store, jnew.store
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    for n in PARAMS:
        np.testing.assert_allclose(
            getattr(got.params, n).numpy(),
            np.asarray(getattr(want.params, n)), rtol=1e-6,
            atol=1e-6 if n in ("means", "scales") else 0, err_msg=n)
    for n in STATS:
        np.testing.assert_array_equal(getattr(got, n).numpy(),
                                      np.asarray(getattr(want, n)), err_msg=n)
    for name, s in jnew.opt.items():
        np.testing.assert_array_equal(tnew.opt[name].mu.numpy(),
                                      np.asarray(s.mu), err_msg=name)
        np.testing.assert_array_equal(tnew.opt[name].nu.numpy(),
                                      np.asarray(s.nu), err_msg=name)
    assert tnew.step == start.step == STEP0 + 2
    assert torch.equal(start.store.active, T(np.asarray(j2.store.active)))
    # Without noise the pass draws its own from the state's generator.
    again, info = tts.refine_step(start, CFG, 3, 64)
    assert int(info["gaussian_count"]) == int(again.store.active.sum())
