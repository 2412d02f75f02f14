"""The port's core math (street_gaussians_ns_tpu_torch.core) against the
JAX package on the same numpy inputs, on the CPU.

Tolerances: float32 elementwise math agrees to rounding (1e-6 absolute on
O(1) values, 1e-5 on projected pixel quantities); the integer outputs of
projection (radii, tile boxes, tile counts) and the coverage predicate
must agree exactly, since they decide pair enumeration."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.core import cameras as jcam
from street_gaussians_ns_tpu.core import projection as jproj
from street_gaussians_ns_tpu.core import quaternions as jquat
from street_gaussians_ns_tpu.core import sh as jsh
from street_gaussians_ns_tpu.ops import rasterize_ref as jref
from street_gaussians_ns_tpu_torch.core import cameras as tcam
from street_gaussians_ns_tpu_torch.core import projection as tproj
from street_gaussians_ns_tpu_torch.core import quaternions as tquat
from street_gaussians_ns_tpu_torch.core import sh as tsh
from street_gaussians_ns_tpu_torch.ops import rasterize_ref as tref

from test_rasterize import make_scene


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


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q[0] = 0.0                         # zero-safe normalize
    return q


def test_quaternion_ops_match_jax():
    rng = np.random.default_rng(0)
    a, b = _quats(rng, 64), _quats(rng, 64)
    np.testing.assert_allclose(N(tquat.normalize(T(a))),
                               N(jquat.normalize(a)), atol=1e-6)
    an = N(jquat.normalize(a))[1:]
    bn = N(jquat.normalize(b))[1:]
    np.testing.assert_allclose(N(tquat.to_rotmat(T(an))),
                               N(jquat.to_rotmat(an)), atol=1e-6)
    np.testing.assert_allclose(N(tquat.multiply(T(an), T(bn))),
                               N(jquat.multiply(an, bn)), atol=1e-6)
    m = N(jquat.to_rotmat(an))
    np.testing.assert_allclose(N(tquat.from_rotmat(T(m))),
                               N(jquat.from_rotmat(m)), atol=1e-6)
    t = rng.random(an.shape[0]).astype(np.float32)
    np.testing.assert_allclose(N(tquat.slerp(T(an), T(bn), T(t))),
                               N(jquat.slerp(an, bn, t)), atol=1e-6)
    # Nearly parallel quats take the lerp branch; scalar t broadcasts.
    np.testing.assert_allclose(
        N(tquat.slerp(T(an), T(an + 1e-8), 0.3)),
        N(jquat.slerp(an, an + 1e-8, 0.3)), atol=1e-6)


def test_camera_viewmat_and_pixel_directions_match_jax():
    rng = np.random.default_rng(1)
    R = N(jquat.to_rotmat(jquat.normalize(_quats(rng, 2)[1])))
    c2w = np.concatenate([R, rng.standard_normal((3, 1))], 1).astype(
        np.float32)
    np.testing.assert_allclose(N(tcam.viewmat_from_c2w(T(c2w))),
                               N(jcam.viewmat_from_c2w(c2w)), atol=1e-6)
    jc = jcam.Camera.make(50.0, 55.0, 20.5, 14.0, c2w, 40, 30, time=0.25)
    tc = tcam.Camera.make(50.0, 55.0, 20.5, 14.0, c2w, 40, 30, time=0.25,
                          device="cpu")
    assert (tc.width, tc.height) == (40, 30)
    np.testing.assert_allclose(N(tcam.pixel_directions(tc)),
                               N(jcam.pixel_directions(jc)), atol=1e-6)
    fish = tcam.Camera.make(50.0, 55.0, 20.5, 14.0, c2w, 40, 30,
                            device="cpu", model=tcam.FISHEYE)
    with pytest.raises(NotImplementedError):
        tcam.pixel_directions(fish)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    d = rng.standard_normal((50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    k = tsh.num_sh_bases(degree)
    assert k == jsh.num_sh_bases(degree)
    coeffs = rng.standard_normal((50, k, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tsh.sh_basis(T(d), degree)),
                               N(jsh.sh_basis(d, degree)), atol=1e-6)
    for active in range(degree + 1):
        np.testing.assert_allclose(
            N(tsh.eval_sh(active, T(d), T(coeffs))),
            N(jsh.eval_sh(active, d, coeffs)), atol=2e-6)
    rgb = rng.random((7, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tsh.rgb2sh(T(rgb))), N(jsh.rgb2sh(rgb)),
                               atol=1e-6)


def _project_both(seed, n, w, h, with_opacity):
    means, scales, quats, colors, opac, cam = make_scene(n, seed, w=w, h=h)
    args = [np.asarray(a) for a in (means, scales, quats)]
    vm = np.asarray(jcam.viewmat_from_c2w(cam.c2w))
    op = np.asarray(opac)
    kw = dict(tile_size=16)
    pj = jproj.project(*args, vm, cam.fx, cam.fy, cam.cx, cam.cy, w, h,
                       opacities=op if with_opacity else None, **kw)
    f = [torch.tensor(float(v)) for v in (cam.fx, cam.fy, cam.cx, cam.cy)]
    pt = tproj.project(*map(T, args), T(vm), *f, w, h,
                       opacities=T(op) if with_opacity else None, **kw)
    return pj, pt, op


@pytest.mark.parametrize("seed,n,w,h,with_opacity", [
    (0, 200, 64, 64, False), (3, 300, 50, 37, True),
    (5, 400, 96, 64, True)])
def test_projection_matches_jax(seed, n, w, h, with_opacity):
    pj, pt, _ = _project_both(seed, n, w, h, with_opacity)
    for name in ("radii", "tile_box", "num_tiles_hit"):
        np.testing.assert_array_equal(N(getattr(pt, name)),
                                      N(getattr(pj, name)), err_msg=name)
    for name in ("xys", "conics", "depths", "comp"):
        np.testing.assert_allclose(N(getattr(pt, name)),
                                   N(getattr(pj, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert int((N(pt.num_tiles_hit) > 0).sum()) > 0
    np.testing.assert_allclose(
        N(tproj.compute_cov3d(T(np.ones((4, 3), np.float32)),
                              T(np.eye(4, dtype=np.float32)))),
        N(jproj.compute_cov3d(jnp.ones((4, 3)), jnp.eye(4))), atol=1e-6)


def test_coverage_predicate_matches_jax_exactly():
    """coverage_q / row_tile_range on the same (projected) inputs: the
    tile-column range of every (gaussian, tile row) must be identical."""
    pj, _, op = _project_both(4, 300, 80, 48, True)
    conics, xys, box = (np.asarray(pj.conics), np.asarray(pj.xys),
                        np.asarray(pj.tile_box))
    qj = np.asarray(jproj.coverage_q(op))
    qt = N(tproj.coverage_q(T(op)))
    np.testing.assert_allclose(qt, qj, rtol=1e-6, atol=1e-6)
    ty = np.arange(3, dtype=np.int32)[None, :]
    xj = jproj.row_tile_range(conics[:, None], xys[:, None], box[:, None],
                              box[:, None, 2] + ty, 16, qj[:, None])
    xt = tproj.row_tile_range(T(conics)[:, None], T(xys)[:, None],
                              T(box)[:, None], T(box)[:, None, 2] + T(ty),
                              16, T(qj)[:, None])
    for a, b in zip(xt, xj):
        np.testing.assert_array_equal(N(a), N(b))


def test_oracle_rasterizer_matches_jax():
    pj, _, op = _project_both(2, 60, 32, 32, False)
    rng = np.random.default_rng(2)
    colors = rng.random((60, 3)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    args = [np.asarray(a) for a in (pj.xys, pj.depths, pj.radii, pj.conics)]
    img_j, a_j = jref.rasterize_reference(
        *args, colors, op, np.asarray(pj.tile_box), 32, 32, background=bg)
    img_t, a_t = tref.rasterize_reference(
        *map(T, args), T(colors), T(op), T(np.asarray(pj.tile_box)), 32, 32,
        background=T(bg))
    np.testing.assert_allclose(N(img_t), N(img_j), atol=1e-5)
    np.testing.assert_allclose(N(a_t), N(a_j), atol=1e-5)
    assert float(N(a_t).max()) > 0.3
    assert tref.ALPHA_THRESH == jref.ALPHA_THRESH
    assert tref.ALPHA_CLAMP == jref.ALPHA_CLAMP
    assert tref.T_EPS == jref.T_EPS
    assert tref.SIGMA_MIN == jref.SIGMA_MIN
    assert tproj.CLIP_THRESH == jproj.CLIP_THRESH
