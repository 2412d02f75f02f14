"""The port's store initialisation (models/gaussians.init_gaussians,
knn_avg_dist, core/quaternions.shoemake_quats,
models/scene_graph.init_scene_graph_store) against the JAX package's.

The uniform draws are made with the JAX package's keys and handed to the
port, so every leaf is compared: integers and masks exactly, floats at
rtol 1e-6 / atol 1e-6 (sin, cos, sqrt and log of the same float32
numbers in two libraries)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.core import quaternions as jquat
from street_gaussians_ns_tpu.models import gaussians as jgauss
from street_gaussians_ns_tpu.models import scene_graph as jsg
from street_gaussians_ns_tpu_torch.core import quaternions as tquat
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.engine import scene_train_step as tsts
from street_gaussians_ns_tpu_torch.models import gaussians as tgauss
from street_gaussians_ns_tpu_torch.models import scene_graph as tsg

from test_torch_scene_graph import port_config, store_arrays


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


def _jax_noise(key, n):
    """The draws jgauss.init_gaussians makes from `key` for n gaussians."""
    k_means, k_quat, k_dc = jax.random.split(key, 3)
    u = lambda k, shape: np.asarray(  # noqa: E731
        jax.random.uniform(k, shape, jnp.float32))
    return {"means": T(u(k_means, (n, 3))),
            "quats": T(np.stack([u(k, (n,))
                                 for k in jax.random.split(k_quat, 3)])),
            "dc": T(u(k_dc, (n, 3)))}


def _assert_stores_equal(got, want):
    np.testing.assert_array_equal(got.active.numpy(),
                                  np.asarray(want.active))
    for f in dataclasses.fields(want.params):
        np.testing.assert_allclose(
            getattr(got.params, f.name).numpy(),
            np.asarray(getattr(want.params, f.name)), rtol=1e-6, atol=1e-6,
            err_msg=f.name)
    for k in ("xys_grad_norm", "vis_counts", "max_2dsize"):
        assert not getattr(got, k).any() and getattr(got, k).shape == \
            got.active.shape


def test_shoemake_quats_match_jax():
    key = jax.random.PRNGKey(4)
    u = np.stack([np.asarray(jax.random.uniform(k, (50,), jnp.float32))
                  for k in jax.random.split(key, 3)])
    got = tquat.shoemake_quats(T(u))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jquat.random_quats(key, 50)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("n_seed,cap,colors", [(200, 256, True),
                                               (300, 128, True),
                                               (40, 64, False), (1, 8, True)])
def test_init_gaussians_from_seed_points_matches_jax(n_seed, cap, colors):
    rng = np.random.default_rng(n_seed)
    pts = rng.standard_normal((n_seed, 3)).astype(np.float32) * 3.0
    cols = rng.integers(0, 256, (n_seed, 3)).astype(np.uint8) if colors \
        else None
    key = jax.random.PRNGKey(7)
    want = jgauss.init_gaussians(cap, pts, cols, sh_degree=2, fourier_dim=3,
                                 rng=key)
    n = min(n_seed, cap)
    got = tgauss.init_gaussians(cap, pts, cols, sh_degree=2, fourier_dim=3,
                                noise=_jax_noise(key, n), device="cpu")
    _assert_stores_equal(got, want)
    assert int(got.active.sum()) == n
    assert got.params.features_rest.shape == (cap, 8, 3)
    np.testing.assert_allclose(
        tgauss.knn_avg_dist(pts[:n]) if n > 3 else 1.0,
        jgauss.knn_avg_dist(pts[:n]) if n > 3 else 1.0)


def test_init_gaussians_random_cloud_matches_jax():
    key = jax.random.PRNGKey(1)
    want = jgauss.init_gaussians(96, None, None, sh_degree=1, fourier_dim=5,
                                 num_random=48, random_scale=6.0, rng=key)
    got = tgauss.init_gaussians(96, None, None, sh_degree=1, fourier_dim=5,
                                num_random=48, random_scale=6.0,
                                noise=_jax_noise(key, 48), device="cpu")
    _assert_stores_equal(got, want)
    # Drawn from its own generator: same structure, reproducible by seed.
    a = tgauss.init_gaussians(96, None, None, num_random=48, seed=3,
                              device="cpu")
    b = tgauss.init_gaussians(96, None, None, num_random=48, seed=3,
                              device="cpu")
    c = tgauss.init_gaussians(96, None, None, num_random=48, seed=4,
                              device="cpu")
    assert torch.equal(a.params.means, b.params.means)
    assert not torch.equal(a.params.means, c.params.means)
    assert float(a.params.means.abs().max()) <= 5.0
    np.testing.assert_allclose(a.params.quats[:48].norm(dim=-1).numpy(),
                               1.0, atol=1e-6)
    assert torch.equal(a.params.quats[48:, 0], torch.ones(48))


def test_init_scene_graph_store_matches_jax_and_trains():
    from __graft_entry__ import _tiny_scene

    jcfg, jstore, jtracks = _tiny_scene()
    cfg = port_config(jcfg)
    carried = tckpt.store_from_numpy(store_arrays(jstore), cfg, device="cpu")
    tracks = tckpt.tracks_from_numpy(store_arrays(jtracks), device="cpu")
    got = tsg.init_scene_graph_store(carried.background, carried.objects,
                                     tracks, cfg, device="cpu")
    want = jsg.init_scene_graph_store(jstore.background, jstore.objects,
                                      jtracks, jcfg)
    for name in ("env_map", "delta_center", "delta_yaw", "delta_rot"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    no_sky = tsg.init_scene_graph_store(
        carried.background, carried.objects, tracks, dataclasses.replace(
            cfg, base=dataclasses.replace(cfg.base, use_sky_sphere=False)),
        device="cpu")
    assert no_sky.env_map is None
    state = tsts.init_scene_train_state(got, torch.Generator().manual_seed(0))
    assert state.step == 0 and set(state.opt) == {
        "means", "scales", "quats", "features_dc", "features_rest",
        "opacities", "sky_sphere", "bbox_opt"}
    assert "sky_sphere" not in tsts.init_scene_train_state(
        no_sky, torch.Generator().manual_seed(0)).opt
