"""Kernel L's specification on the CPU: the closed-form backward of the
projection (ops.project._project_vjp_plain) against autograd through the
plain version (core.projection._project_plain) in float64, on every
branch of tests/project_cases.py; `project`'s mask and offset on CPU
tensors; and the wrappers' refusals before any pointer reaches C. The
card tests (tests/test_torch_cuda.py) hold the kernel to both."""
import pytest
import torch

from project_cases import CASES, HEIGHT, WIDTH, compared, inputs
from street_gaussians_ns_tpu_torch.core.projection import (_project_plain,
                                                          project)
from street_gaussians_ns_tpu_torch.ops import project as project_kernel

F64 = torch.float64


def _autograd(case, with_comp, view_grad=True, seed=0):
    means, scales, quats, opac, vm, fx, fy, cx, cy = inputs(case, seed=seed,
                                                            dtype=F64)
    leaves = [t.clone().requires_grad_(True) for t in (means, scales, quats)]
    vm_leaf = vm.clone().requires_grad_(view_grad)
    p = _project_plain(*leaves, vm_leaf, fx, fy, cx, cy, WIDTH, HEIGHT,
                       opacities=opac, dtype=F64)
    gen = torch.Generator().manual_seed(seed + 1)
    keep = compared(case, p).to(F64)
    g = [torch.randn(t.shape, dtype=F64, generator=gen)
         * keep.reshape((-1,) + (1,) * (t.dim() - 1))
         for t in (p.xys, p.depths, p.conics, p.comp)]
    outs = [p.xys, p.depths, p.conics] + ([p.comp] if with_comp else [])
    want = torch.autograd.grad(outs, leaves + ([vm_leaf] if view_grad
                                               else []), g[:len(outs)])
    got = project_kernel._project_vjp_plain(
        means, scales, quats, vm, fx, fy, cx, cy, WIDTH, HEIGHT, 0.01, g[0],
        g[1], g[2], g[3] if with_comp else None)
    return p, want, got


@pytest.mark.parametrize("with_comp", [False, True], ids=["no_comp", "comp"])
@pytest.mark.parametrize("case", CASES)
def test_vjp_plain_matches_autograd(case, with_comp):
    """The closed form equals autograd's gradient through the plain
    version in float64, the subgradients included: half the gradient at a
    tie of the frustum clamp, none past it or to the branch a where does
    not take. The tolerance (1e-9 of each gradient's largest element) is
    float64 rounding in a different order of the same terms. Where
    autograd's own rules give NaN (sqrt's gradient g / 0 at a compensation
    of exactly 0 that the clamp passes, which some needles of
    det_nonpositive reach), the closed form gives NaN there too."""
    p, want, got = _autograd(case, with_comp)
    keep = compared(case, p)
    for name, w, g in zip(("means", "scales", "quats", "viewmat"), want,
                          got):
        rows = w if name == "viewmat" else w[keep]
        if not with_comp:
            assert bool(torch.isfinite(rows).all()), name
        top = float(rows[torch.isfinite(rows)].abs().max())
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-9 * top,
                                   equal_nan=True,
                                   msg=lambda m: f"{case} {name}: {m}")


def test_cases_reach_their_branches():
    """Each case reaches what it is named for (float32, as the card runs
    them, and float64)."""
    for dt in (torch.float32, F64):
        def proj(case):
            a = inputs(case, dtype=dt)
            means, scales, quats, opac, vm, fx, fy, cx, cy = a
            return a, _project_plain(means, scales, quats, vm, fx, fy, cx,
                                     cy, WIDTH, HEIGHT, opacities=opac,
                                     dtype=dt)

        (m, *_), p = proj("behind_near_clip")
        assert bool((p.radii[m[:, 2] <= 0.01] == 0).all())
        assert bool((m[:, 2] <= 0.01).any() & (m[:, 2] > 0).any())
        (m, s, q, o, vm, fx, *_), p = proj("frustum_tie")
        lim = 1.3 * (0.5 * WIDTH / fx)
        assert bool((m[0::4, 0] / m[0::4, 2] == lim).all())
        _, p = proj("det_nonpositive")
        assert bool(compared("det_nonpositive", p).any())
        assert bool((p.radii > 0).any())
        (m, s, q, o, *_), p = proj("faint_opacity")
        assert bool((p.radii[o < 1.0 / 255] == 0).all())
        (m, s, q, *_), p = proj("zero_quaternion")
        assert bool((q == 0).all(dim=-1).any())
        _, p = proj("tile_edges")
        assert bool((p.xys % 16 == 0).all())


def test_vjp_plain_takes_missing_cotangents_as_none():
    """A cotangent not given is skipped, as autograd skips an output that
    nothing read: the depths' alone reach only the means' z path; no
    cotangent at all gives zero gradients."""
    means, scales, quats, opac, vm, fx, fy, cx, cy = inputs("in_view",
                                                            dtype=F64)
    gd = torch.ones(means.shape[0], dtype=F64)
    d_m, d_s, d_q, d_v = project_kernel._project_vjp_plain(
        means, scales, quats, vm, fx, fy, cx, cy, WIDTH, HEIGHT, 0.01,
        g_depths=gd)
    torch.testing.assert_close(d_m, vm[2, :3].expand_as(d_m))
    assert not d_s.any() and not d_q.any()
    none = project_kernel._project_vjp_plain(
        means, scales, quats, vm, fx, fy, cx, cy, WIDTH, HEIGHT, 0.01)
    assert not any(bool(t.any()) for t in none)


def test_project_on_cpu_runs_the_plain_version_with_mask_and_offset():
    """CPU tensors run _project_plain; `active` zeroes radius and tile
    count outside it, `xys_offset` adds to the centres and takes their
    gradient."""
    means, scales, quats, opac, vm, fx, fy, cx, cy = inputs("in_view")
    n = means.shape[0]
    active = torch.arange(n) % 3 != 0
    off = torch.zeros((n, 2), requires_grad=True)
    plain = _project_plain(means, scales, quats, vm, fx, fy, cx, cy, WIDTH,
                           HEIGHT, opacities=opac)
    p = project(means, scales, quats, vm, fx, fy, cx, cy, WIDTH, HEIGHT,
                opacities=opac, active=active, xys_offset=off)
    assert torch.equal(p.xys, plain.xys)
    assert torch.equal(p.radii, torch.where(active, plain.radii, 0))
    assert torch.equal(p.num_tiles_hit,
                       torch.where(active, plain.num_tiles_hit, 0))
    for name in ("depths", "conics", "comp", "tile_box"):
        assert torch.equal(getattr(p, name), getattr(plain, name)), name
    g = torch.randn(n, 2)
    assert torch.equal(torch.autograd.grad(p.xys, off, g)[0], g)


def _operands(n=6):
    z = lambda *s: torch.zeros(s)  # noqa: E731
    return dict(means=z(n, 3), scales=z(n, 3), quats=z(n, 4),
                viewmat=torch.eye(4), fx=torch.tensor(1.0),
                fy=torch.tensor(1.0), cx=torch.tensor(0.0),
                cy=torch.tensor(0.0), opacities=z(n),
                active=torch.ones(n, dtype=torch.bool), xys_offset=z(n, 2))


BAD = {
    "means float64": ("means", lambda a: a.double(), TypeError),
    "means (N, 4)": ("means", lambda a: torch.zeros((6, 4)), ValueError),
    "scales column stride 2": ("scales", lambda a: torch.zeros((6, 6))[
        :, ::2], ValueError),
    "quats rows": ("quats", lambda a: torch.zeros((7, 4)), ValueError),
    "viewmat (3, 4)": ("viewmat", lambda a: torch.zeros((3, 4)), ValueError),
    "viewmat not contiguous": ("viewmat", lambda a: a.T, ValueError),
    "fx a float": ("fx", lambda a: 1.0, TypeError),
    "fx float64": ("fx", lambda a: a.double(), TypeError),
    "fx (1,)": ("fx", lambda a: a[None], ValueError),
    "fx differentiated": ("fx", lambda a: a.clone().requires_grad_(True),
                          ValueError),
    "opacities (N, 1)": ("opacities", lambda a: a[:, None], ValueError),
    "opacities strided": ("opacities", lambda a: torch.zeros(12)[::2],
                          ValueError),
    "active uint8": ("active", lambda a: a.to(torch.uint8), TypeError),
    "xys_offset (N, 3)": ("xys_offset", lambda a: torch.zeros((6, 3)),
                          ValueError),
    "cpu tensors": ("means", lambda a: a, ValueError),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_project_wrappers_raise_on_bad_input(bad):
    """Kernel L's wrappers check dtypes, shapes, strides and the device
    before any pointer reaches C (no launch, no build: these run on the
    CPU, so the operands that pass every other check fail the device
    check)."""
    key, fix, error = BAD[bad]
    a = _operands()
    a[key] = fix(a[key])
    k = project_kernel.PROJECT_KERNEL
    before = k.launches
    with pytest.raises(error):
        project_kernel.project_fwd(
            a["means"], a["scales"], a["quats"], a["viewmat"], a["fx"],
            a["fy"], a["cx"], a["cy"], WIDTH, HEIGHT, 16, 0.01,
            a["opacities"], a["active"], a["xys_offset"])
    if key not in ("opacities", "active", "xys_offset"):
        with pytest.raises(error):
            project_kernel.project_bwd(
                a["means"], a["scales"], a["quats"], a["viewmat"], a["fx"],
                a["fy"], a["cx"], a["cy"], WIDTH, HEIGHT, 0.01,
                torch.zeros((6, 2)), view_grad=True)
    assert k.launches == before


@pytest.mark.parametrize("bad", ["g_xys (N, 3)", "g_conics float64",
                                 "g_depths rows"])
def test_project_bwd_wrapper_raises_on_bad_gradients(bad):
    """The backward wrapper checks each gradient's dtype and shape."""
    a = _operands()
    g = {"g_xys (N, 3)": dict(g_xys=torch.zeros((6, 3))),
         "g_conics float64": dict(g_conics=torch.zeros((6, 3),
                                                       dtype=F64)),
         "g_depths rows": dict(g_depths=torch.zeros(7))}[bad]
    with pytest.raises(ValueError):
        project_kernel.project_bwd(
            a["means"], a["scales"], a["quats"], a["viewmat"], a["fx"],
            a["fy"], a["cx"], a["cy"], WIDTH, HEIGHT, 0.01, **g)
