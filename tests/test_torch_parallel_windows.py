"""The band-sharded SSIM (ops/ssim.ssim_band_mean) and sky
(models/splatfacto.sky_color row0/rows) and the pair-balanced depth
windows (ops/composite._balanced_window) of the port's multi-device
step, against the JAX package's on the CPU.

Tolerances: the bands equal the JAX bands and compose to the full frame
at rtol 2e-6 (SSIM, f32 association) and exactly (sky, against the
port's full frame; atol 1e-6 against the JAX sky); the window bounds
exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from street_gaussians_ns_tpu.models import splatfacto as jsplat
from street_gaussians_ns_tpu.ops import ssim as jssim
from street_gaussians_ns_tpu.ops import tiles as jtiles
from street_gaussians_ns_tpu.ops.composite_pallas import (
    _balanced_window as j_balanced_window)
from street_gaussians_ns_tpu.parallel.mesh import make_mesh as j_make_mesh
from street_gaussians_ns_tpu_torch.core.cameras import Camera as TCamera
from street_gaussians_ns_tpu_torch.models import splatfacto as tsplat
from street_gaussians_ns_tpu_torch.ops import composite as tcomp
from street_gaussians_ns_tpu_torch.ops import ssim as tssim
from street_gaussians_ns_tpu_torch.ops import tiles as ttiles

from test_fused_binning import _project
from test_pallas_composite import make_scene
from test_scene_graph import H, W
from test_sharded import make_cameras


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


@pytest.mark.parametrize("parts", [2, 4])
def test_ssim_bands_match_jax_and_compose(parts):
    rng = np.random.default_rng(parts)
    a = rng.random((48, 64, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    band = -(-(48 - 10) // parts)
    got = [float(tssim.ssim_band_mean(T(a), T(b), m * band, band))
           for m in range(parts)]
    want = [float(jssim.ssim_band_mean(a, b, m * band, band))
            for m in range(parts)]
    np.testing.assert_allclose(got, want, rtol=2e-6)
    np.testing.assert_allclose(sum(got), float(tssim.ssim(T(a), T(b))),
                               rtol=2e-6)


def test_sky_bands_match_jax_and_compose():
    jenv = jsplat.init_env_map(jsplat.SplatfactoConfig(env_map_res=16))
    env = T(np.random.default_rng(0).random(jenv.shape, dtype=np.float32))
    jenv = jnp.asarray(env.numpy())
    jcam = make_cameras(1)[0]
    cam = TCamera.make(40.0, 40.0, W / 2, H / 2, np.eye(3, 4), W, H,
                       device="cpu")
    key = jax.random.PRNGKey(3)
    jitter = T(jax.random.uniform(key, (2, H, W), jnp.float32))
    full = tsplat.sky_color(env, cam, jitter)
    np.testing.assert_allclose(full.numpy(),
                               np.asarray(jsplat.sky_color(jenv, jcam, key)),
                               atol=1e-6)
    for jit, jkey in ((jitter, key), (None, None)):
        band = -(-H // 3)                  # the last band is padding-cut
        parts = [tsplat.sky_color(env, cam, jit, row0=m * band, rows=band)
                 for m in range(3)]
        want = [jsplat.sky_color(jenv, jcam, jkey, row0=m * band, rows=band)
                for m in range(3)]
        for p, w in zip(parts, want):
            np.testing.assert_allclose(p.numpy(), np.asarray(w), atol=1e-6)
        np.testing.assert_array_equal(
            torch.cat(parts)[:H].numpy(),
            tsplat.sky_color(env, cam, jit).numpy())


@pytest.fixture(scope="module")
def far_heavy_cols(n=256, seed=5, w=96, h=64):
    """A scene whose pairs sit at the far end of the depth order (far
    splats scaled up, as tests/test_sharded.py's far-heavy case), sorted
    by both packages."""
    means, scales, quats, colors, opac, cam = make_scene(n, seed, w=w, h=h)
    depth = -means[:, 2]
    scales = scales * (1.0 + 3.0 * jnp.clip(depth - 6.0, 0.0, None))[:, None]
    p = _project(means, scales, quats, cam)
    dk = jnp.where(p.num_tiles_hit > 0, p.depths, jnp.inf)
    nty = -(-h // 16)
    jcols, _, _ = jtiles._depth_sort_cols(
        p.xys, p.conics, p.tile_box, dk, colors, opac, -(-w // 16), nty,
        False, "f32")
    tcols = ttiles._depth_sort_cols(T(p.xys), T(p.conics), T(p.tile_box),
                                    T(dk), T(colors), T(opac), False)
    return jcols, tcols, n, nty


@pytest.mark.parametrize("model", [2, 4])
def test_balanced_window_matches_jax(model, far_heavy_cols):
    """The bounds (anchor, local lo, local hi) of every device's window:
    the JAX function under shard_map on `model` virtual devices, the
    port's with the group's all-gather standing in as the full trim (the
    equal windows' trims, concatenated in device order)."""
    jcols, tcols, n, nty = far_heavy_cols
    slice_size = n // model
    mesh = j_make_mesh(data=1, model=model)

    def body(*cols):
        sl0 = jax.lax.axis_index("model") * slice_size
        anchor, _, (lo, hi), _ = j_balanced_window(
            cols, n, sl0, slice_size, nty, False, "model")
        return jnp.stack([anchor, lo, hi]).astype(jnp.int32)[None]

    want = np.asarray(jax.shard_map(
        body, mesh=mesh, in_specs=(P(),) * 16, out_specs=P("model"),
        check_vma=False)(*jcols))
    full = ttiles._trim_full(tcols, 16, nty)
    cum = np.cumsum(np.where(np.isfinite(tcols[0].numpy()),
                             full[2].numpy(), 0))
    # Far-heavy: the far half of the order holds most of the pairs.
    assert cum[-1] - cum[n // 2] > 2 * cum[n // 2]
    got = []
    for m in range(model):
        parts = iter(full)
        anchor, s_cap, (lo, hi), _ = tcomp._balanced_window(
            tcols, n, m * slice_size, slice_size, nty,
            gather=lambda x: next(parts))
        assert s_cap == min(2 * slice_size, n)
        assert 0 <= int(anchor) <= n - s_cap
        got.append([int(anchor), int(lo), int(hi)])
    np.testing.assert_array_equal(np.array(got), want)
    # The windows partition the order, and are not the equal split.
    starts = [a + lo for a, lo, _ in got]
    ends = [a + hi for a, _, hi in got]
    assert starts[0] == 0 and ends[-1] == n and starts[1:] == ends[:-1]
    assert starts != [m * slice_size for m in range(model)]
