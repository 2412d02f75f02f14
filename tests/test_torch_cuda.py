"""Each CUDA kernel of the port against its plain PyTorch version on the
card. These tests import neither JAX nor tests/conftest.py's JAX set-up,
so they run on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""

Without a card they skip. Tolerances: the scan, the expansion and the
pack are exact; the compositor is built without multiply-add contraction
(ops/_cuda.py) and so rounds as its plain version does: n_contrib equal,
accum and T at atol 2e-5. The backward compositor replays the forward bit
for bit but adds its 256 pixels in a shuffle tree where the plain version
uses torch.sum: rtol 1e-4 with atol 1e-5 of the largest gradient, the rank
row exact. The rank sum adds a run in pair order like index_add_ on the
CPU, but a warp shares runs above 32 pairs: rtol 1e-5 / atol 1e-5."""
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu_torch.core.cameras import Camera, viewmat_from_c2w
from street_gaussians_ns_tpu_torch.core.projection import project
from street_gaussians_ns_tpu_torch.ops import (composite, expand, scan,
                                               segreduce)
from street_gaussians_ns_tpu_torch.ops.tiles import bin_and_pack


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ragged(rng, n_src, c, p_zero):
    counts = rng.integers(1, 7, size=n_src)
    counts[rng.random(n_src) < p_zero] = 0
    ends = np.cumsum(counts).astype(np.int32)
    return (rng.standard_normal((c, n_src)).astype(np.float32),
            (ends - counts).astype(np.int32), ends)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4096, 4097, 1_700_000])
def test_scan_kernel_matches_plain(cuda, m):
    x = torch.from_numpy(np.random.default_rng(m).integers(
        -5, 9, m).astype(np.int32)).to(cuda)
    assert torch.equal(scan.cumsum_flat(x), scan.cumsum_flat_plain(x))
    assert torch.equal(scan.cummax_flat(x), scan.cummax_flat_plain(x))
    xf = x.float()
    assert torch.equal(scan.cummax_flat(xf), scan.cummax_flat_plain(xf))
    torch.testing.assert_close(scan.cumsum_flat(xf),
                               scan.cumsum_flat_plain(xf))


@pytest.mark.cuda
@pytest.mark.parametrize("out_len", [12000, 5000])
def test_expand_kernel_matches_plain(cuda, out_len):
    src, starts, ends = _ragged(np.random.default_rng(1), 3000, 16, 0.3)
    args = [torch.from_numpy(a).to(cuda) for a in (src, starts, ends)]
    assert torch.equal(expand.expand_ragged(*args, out_len),
                       expand.expand_ragged_plain(*args, out_len))


@pytest.mark.cuda
def test_pack_and_composite_kernels_match_plain(cuda):
    rng = np.random.default_rng(0)
    n, w, h = 3000, 200, 120
    means = np.concatenate([rng.standard_normal((n, 2)),
                            -rng.random((n, 1)) * 8.0 - 2.0], 1)
    q = rng.standard_normal((n, 4))
    args = [torch.tensor(a, dtype=torch.float32) for a in (
        means, np.exp(rng.standard_normal((n, 3)) * 0.5 - 2.5),
        q / np.linalg.norm(q, axis=1, keepdims=True))]
    op = torch.tensor(rng.random(n) * 0.9 + 0.05, dtype=torch.float32)
    colors = torch.tensor(rng.random((n, 4)), dtype=torch.float32)
    cam = Camera.make(100.0, 100.0, w / 2, h / 2, np.eye(3, 4), w, h,
                      device="cpu")
    p = project(*args, viewmat_from_c2w(cam.c2w), cam.fx, cam.fy, cam.cx,
                cam.cy, w, h, opacities=op)
    depth_key = torch.where(p.num_tiles_hit > 0, p.depths,
                            torch.full_like(p.depths, float("inf")))
    max_pairs = 1 << 15
    bins, feats = bin_and_pack(p.xys, p.conics, p.tile_box, depth_key,
                               colors, op, w, h, 16, max_pairs)
    assert 0 < int(bins.num_pairs) <= max_pairs
    cols = [f.to(cuda) for f in feats]
    feat = composite.pack_feat_cols(cols, max_pairs)
    assert torch.equal(feat, composite.pack_feat_cols_plain(cols, max_pairs))
    ts, tc = bins.tile_start.to(cuda), bins.tile_count.to(cuda)
    ntx = (w + 15) // 16
    got = composite.composite_fwd(feat, ts, tc, ntx, 4)
    want = composite.composite_fwd_plain(feat, ts, tc, ntx, 4)
    assert torch.equal(got[2], want[2])
    for g, x in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, x, atol=2e-5, rtol=0)
    assert float(1.0 - got[1].min()) > 0.5


def _binned_stream(seed, n, w, h, opaque=False, spread=1.0):
    """A projected random scene binned on the CPU: (feat stream, bins)."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.standard_normal((n, 2)) * spread,
                            -rng.random((n, 1)) * 8.0 - 2.0], 1)
    q = rng.standard_normal((n, 4))
    args = [torch.tensor(a, dtype=torch.float32) for a in (
        means, np.exp(rng.standard_normal((n, 3)) * 0.5
                      - (1.0 if opaque else 2.5)),
        q / np.linalg.norm(q, axis=1, keepdims=True))]
    op = torch.tensor(np.full(n, 0.9995) if opaque
                      else rng.random(n) * 0.9 + 0.05, dtype=torch.float32)
    colors = torch.tensor(rng.random((n, 4)), dtype=torch.float32)
    cam = Camera.make(100.0, 100.0, w / 2, h / 2, np.eye(3, 4), w, h,
                      device="cpu")
    p = project(*args, viewmat_from_c2w(cam.c2w), cam.fx, cam.fy, cam.cx,
                cam.cy, w, h, opacities=op)
    depth_key = torch.where(p.num_tiles_hit > 0, p.depths,
                            torch.full_like(p.depths, float("inf")))
    max_pairs = 1 << 15
    bins, feats = bin_and_pack(p.xys, p.conics, p.tile_box, depth_key,
                               colors, op, w, h, 16, max_pairs)
    assert 0 < int(bins.num_pairs) <= max_pairs
    return composite.pack_feat_cols_plain(feats, max_pairs), bins


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,w,h,opaque,spread,nc", [
    (0, 3000, 200, 120, False, 1.0, 4),     # ragged size, deep tiles
    (1, 400, 200, 120, False, 0.2, 3),      # most tiles empty
    (2, 1500, 70, 50, True, 1.0, 4),        # every pixel saturates early
    (3, 40, 33, 17, False, 1.0, 1)])
def test_composite_bwd_kernel_matches_plain(cuda, seed, n, w, h, opaque,
                                            spread, nc):
    feat, bins = _binned_stream(seed, n, w, h, opaque, spread)
    feat = feat.to(cuda)
    ts, tc = bins.tile_start.to(cuda), bins.tile_count.to(cuda)
    ntx = bins.num_tiles_x
    accum, tfin, ncon = composite.composite_fwd(feat, ts, tc, ntx, nc)
    if spread < 1.0:
        assert int((tc == 0).sum()) > ts.numel() // 2
    if opaque:
        assert float(tfin.median()) < 0.05      # most pixels saturate
    g = torch.Generator(device=cuda).manual_seed(seed)
    scale = 1.0 / (w * h * nc)
    g_accum = torch.randn(accum.shape, device=cuda, generator=g) * scale
    g_t = torch.randn(tfin.shape, device=cuda, generator=g) * scale
    before = composite.BWD_KERNEL.launches
    got = composite.composite_bwd(feat, ts, tc, ntx, nc, g_accum, g_t, tfin,
                                  ncon, accum)
    assert composite.BWD_KERNEL.launches == before + 1
    want = composite.composite_bwd_plain(
        feat, ts, tc, ntx, nc, g_accum, g_t, tfin, ncon,
        (g_accum * accum).sum(-1))
    torch.cuda.synchronize()
    assert torch.equal(got[:, 10], want[:, 10])
    assert not got[:, 11:].any() and not got[:, 6 + nc:10].any()
    top = float(want[:, :10].abs().max())
    assert top > scale
    torch.testing.assert_close(got[:, :10], want[:, :10], rtol=1e-4,
                               atol=1e-5 * top)
    # The same launch twice gives the same bits (no atomics).
    again = composite.composite_bwd(feat, ts, tc, ntx, nc, g_accum, g_t,
                                    tfin, ncon, accum)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("p_len,n_out,long_run", [
    (0, 50, 0), (1, 1, 0), (12345, 700, 0), (40000, 3000, 9000),
    (5000, 300, 5000)])
def test_ranksum_kernel_matches_plain(cuda, p_len, n_out, long_run):
    rng = np.random.default_rng(p_len)
    ranks = rng.integers(0, n_out + 1, size=p_len)
    if long_run:
        ranks[:long_run] = n_out // 3          # one rank owns a long run
    if n_out > 100:
        ranks[ranks == 7] = 8                  # a rank with no pairs
    ranks = np.sort(ranks).astype(np.int32)
    vals = rng.standard_normal((10, p_len)).astype(np.float32)
    rows = torch.from_numpy(np.concatenate(
        [vals, ranks[None].astype(np.float32)])).to(cuda)
    r = torch.from_numpy(ranks).to(cuda)
    before = segreduce.KERNEL.launches
    got = segreduce.rank_rowsum(rows, r, n_out)
    assert segreduce.KERNEL.launches == before + 1
    want = segreduce.rank_rowsum_plain(rows.cpu(), r.cpu(), n_out)
    assert tuple(got.shape) == (10, n_out)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    if n_out > 100:
        assert not got[:, 7].any()
    assert torch.equal(got, segreduce.rank_rowsum(rows, r, n_out))
    # Everything in the discard bucket: all zeros.
    if p_len:
        full = torch.full_like(r, n_out)
        assert not segreduce.rank_rowsum(rows, full, n_out).any()


@pytest.mark.cuda
def test_fused_rasterizer_gradients_on_the_card_match_the_cpu(cuda):
    """The autograd Function end to end: kernels C, D, E, F on the card
    against their plain versions on the CPU, from the same projection."""
    import dataclasses

    rng = np.random.default_rng(5)
    n, w, h = 2000, 150, 90
    means = np.concatenate([rng.standard_normal((n, 2)),
                            -rng.random((n, 1)) * 8.0 - 2.0], 1)
    q = rng.standard_normal((n, 4))
    args = [torch.tensor(a, dtype=torch.float32) for a in (
        means, np.exp(rng.standard_normal((n, 3)) * 0.5 - 2.5),
        q / np.linalg.norm(q, axis=1, keepdims=True))]
    op = torch.tensor(rng.random(n) * 0.9 + 0.05, dtype=torch.float32)
    colors = torch.tensor(rng.random((n, 4)), dtype=torch.float32)
    target = torch.tensor(rng.random((h, w, 4)), dtype=torch.float32)
    cam = Camera.make(100.0, 100.0, w / 2, h / 2, np.eye(3, 4), w, h,
                      device="cpu")
    p = project(*args, viewmat_from_c2w(cam.c2w), cam.fx, cam.fy, cam.cx,
                cam.cy, w, h, opacities=op)
    grads = {}
    for dev in ("cpu", cuda):
        pd = dataclasses.replace(p, **{
            f.name: getattr(p, f.name).to(dev)
            for f in dataclasses.fields(p)})
        leaves = [t.to(dev).requires_grad_(True)
                  for t in (p.xys, p.conics, colors, op)]
        pd = dataclasses.replace(pd, xys=leaves[0], conics=leaves[1])
        img, alpha, _ = composite.rasterize_tiles_fused(
            pd, leaves[2], leaves[3], w, h, 16, torch.zeros(4, device=dev),
            1 << 15)
        loss = (img - target.to(dev)).abs().mean() + 0.3 * (alpha ** 2).mean()
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
    for name, a, b in zip(("xys", "conics", "colors", "opac"),
                          grads[str(cuda)], grads["cpu"]):
        top = float(b.abs().max())
        assert top > 0, name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * top,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
def test_wrappers_raise_on_bad_cuda_input(cuda):
    x = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        scan.cumsum_flat(x[::2])                    # not contiguous
    with pytest.raises(ValueError):
        expand.expand_ragged(torch.zeros((2, 4), device=cuda), x[:4].cpu(),
                             x[:4], 4)              # mixed devices


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: building a kernel raises, it never falls back."""
    from street_gaussians_ns_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda, "_DEFAULT_NVCC", tmp_path / "no-nvcc")
    for env in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(env, raising=False)
    k = _cuda.Kernel(name="t", source="scan.cu", replaces="-", entries={})
    with pytest.raises(_cuda.KernelBuildError, match="nvcc not found"):
        k.lib()
    assert k.launches == 0


def test_library_is_keyed_by_the_sources():
    from street_gaussians_ns_tpu_torch.ops import _cuda

    paths = {k.library_path() for k in _cuda.KERNELS}
    assert len(paths) == len(_cuda.KERNELS) == 6
    for k in _cuda.KERNELS:
        p = k.library_path()
        assert p.parent == _cuda.BUILD_DIR and p.suffix == ".so"
        assert p.name.startswith(k.source.split(".")[0] + "-")
        assert (_cuda.CSRC / k.source).exists()
