"""Each CUDA kernel of the port against its plain PyTorch version on the
card. These tests import neither JAX nor tests/conftest.py's JAX set-up,
so they run on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""

Without a card they skip. Tolerances: the scan, the expansion and the
pack are exact; the compositor is built without multiply-add contraction
(ops/_cuda.py) and so forms sigma, alpha and T as its plain version does:
n_contrib equal on every pixel, accum (whose colour sums use fused
multiply-adds) and T at atol 2e-5. The flat scan is one launch with look-back
between its blocks: int32 sums, int32 and float32 maxima are exact and
repeat bit for bit on one stream or two; the float32 sum is held at rtol
1e-5 of the largest running sum against a float64 sum and repeats bit for
bit. The backward compositor replays the forward bit
for bit but adds its 256 pixels in registers and a shuffle tree where the
plain version uses torch.sum: rtol 1e-4 with atol 1e-5 of the largest
gradient, the rank row exact. The rank sum adds a run in another order
than index_add_ on the CPU: rtol 1e-5 / atol 1e-5 against it, and bit for
bit the numpy model of its order (tests/test_torch_redesign_df.py); the
segment sum likewise (rtol 1e-4 + atol 1e-5 of the largest |sum|, and bit
for bit its model in tests/test_torch_redesign_gh.py). The row scans:
int32 exact, the float32 sum at rtol 1e-5 of the column's largest running
magnitude against float64, bit for bit their model, one device launch a
call, 200 launches over two streams equal. The compositors' t_in
mode is held as the plain launches are; a tile0 strip must equal the same
tiles of the full launch bit for bit. The row trim (kernel I) equals its
plain version bit for bit in first, last and count, on every input
(tests/trim_cases.py), in one device launch a call. The SH colour
(kernel J) equals the plain formulation that adds in k order bit for bit
(tests/sh_cases.k_order) and the plain version's einsum within 2e-6;
its gradients equal autograd's through the k-order formulation bit for
bit, and through the plain version wherever the two sums are on the same
side of the clamp at 0 (each gradient is one product), NaN where they are
NaN and the sign of a zero not compared; one device launch a call each
way. Adam (kernel K) equals the plain version (the row mask, then
engine/optimizers._adam_plain) run on the card bit for bit, in one device
launch over every leaf of every group."""
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu_torch.core.cameras import Camera, viewmat_from_c2w
from street_gaussians_ns_tpu_torch.core.projection import (_floor_int,
                                                          _project_plain,
                                                          coverage_q,
                                                          project)
from street_gaussians_ns_tpu_torch.core.sh import eval_sh
from street_gaussians_ns_tpu_torch.models import splatfacto
from street_gaussians_ns_tpu_torch.engine import optimizers as opt
from street_gaussians_ns_tpu_torch.ops import (_cuda, adam, composite, expand,
                                               scan, segreduce, sh_colors,
                                               tiles)
from street_gaussians_ns_tpu_torch.ops import project as project_kernel
from street_gaussians_ns_tpu_torch.ops.tiles import bin_and_pack
from test_torch_redesign_df import F_CASES, _case, ranksum_model
from test_torch_redesign_gh import (G_CASES, g_case, h_rows, rowscan_model,
                                    segsum_model)
from sh_cases import inputs as sh_inputs, k_order as sh_k_order
from trim_cases import table as trim_table
import project_cases as proj_cases


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


SCAN_SIZES = [1, scan.TILE - 1, scan.TILE, scan.TILE + 1,
              33 * scan.TILE + 7, 70_001, 2_097_152, (1 << 24) + 3]


def _scan_input(m, dtype, seed=0):
    rng = np.random.default_rng(m + seed)
    if dtype == "int32":
        return torch.from_numpy(rng.integers(-5, 9, m).astype(np.int32))
    return torch.from_numpy(rng.standard_normal(m).astype(np.float32))


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
@pytest.mark.parametrize("m", SCAN_SIZES)
@pytest.mark.parametrize("dtype,op", [("int32", "add"), ("int32", "max"),
                                      ("float32", "max"), ("float32", "add")])
def test_lookback_scan_every_size_and_type(cuda, m, dtype, op):
    x = _scan_input(m, dtype).to(cuda)
    fn, plain = ((scan.cumsum_flat, scan.cumsum_flat_plain) if op == "add"
                 else (scan.cummax_flat, scan.cummax_flat_plain))
    before = scan.KERNEL.launches
    got = fn(x)
    assert scan.KERNEL.launches == before + 1
    if (dtype, op) == ("float32", "add"):
        want = plain(x.double())
        top = float(want.abs().max())
        assert float((got.double() - want).abs().max()) <= 1e-5 * top + 1e-6
    else:
        assert torch.equal(got, plain(x))
    assert _cuda.captured_launches(scan.KERNEL, lambda: fn(x)) == 1
    # A view that starts off a 16-byte boundary takes the scalar loads.
    if m > 1:
        assert torch.equal(fn(x[1:]), fn(x[1:].clone()))
    assert torch.equal(fn(x), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,op", [("int32", "add"), ("int32", "max"),
                                      ("float32", "max"), ("float32", "add")])
def test_lookback_scan_repeats_on_one_stream_and_on_two(cuda, dtype, op):
    """200 launches give one result, and so do launches interleaved on two
    streams (each stream has a scratch of its own)."""
    fn = scan.cumsum_flat if op == "add" else scan.cummax_flat
    xs = [_scan_input(2_097_152 - 5 * i, dtype, seed=i).to(cuda)
          for i in range(2)]
    want = [fn(x) for x in xs]
    torch.cuda.synchronize()
    for _ in range(200):
        assert torch.equal(fn(xs[0]), want[0])
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(100):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(fn(xs[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for o in outs[i]:
            assert torch.equal(o, want[i])
    assert len({k for k in scan._scratch if k[1] in
                {st.cuda_stream for st in streams}}) == 2


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


def _binned_stream(seed, n, w, h, opaque=False, spread=1.0, op_scale=1.0):
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
                      else (rng.random(n) * 0.9 + 0.05) * op_scale,
                      dtype=torch.float32)
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
@pytest.mark.parametrize("nc", [1, 2, 3, 4])
@pytest.mark.parametrize("with_tin", [False, True])
@pytest.mark.parametrize("tile0", [0, 13])
def test_composite_bwd_kernel_every_mode(cuda, nc, with_tin, tile0):
    """Every instantiation of kernel E on a scene with empty tiles,
    one-pair tiles and tiles deeper than two staging batches: against the
    plain version, twice bit-equal, and the same bits into an undefined
    buffer."""
    feat, bins = _binned_stream(7, 3000, 200, 120, op_scale=0.15)
    feat = feat.to(cuda)
    ntx = bins.num_tiles_x
    tc = bins.tile_count.clone()
    tc[::5] = 0
    tc[1::5] = torch.clamp(tc[1::5], max=1)
    n_strip = tc.numel() - tile0 - 7 if tile0 else tc.numel()
    sl = slice(tile0, tile0 + n_strip)
    ts, tc = bins.tile_start[sl].to(cuda), tc[sl].contiguous().to(cuda)
    g = torch.Generator(device=cuda).manual_seed(nc)
    t_in = None
    if with_tin:
        t_in = torch.rand((n_strip, 256), device=cuda, generator=g) * 0.9 + 0.1
        t_in[:, ::7] = 5e-5
        t_in[:, 1::7] *= -1.0
        t_in[3::11] = 2e-5
    accum, tfin, ncon = composite.composite_fwd(feat, ts, tc, ntx, nc,
                                                t_in=t_in, tile0=tile0)
    nvis = composite.visited_counts(ncon, tc)
    assert int(nvis.max()) > 128 and int((nvis == 1).sum()) > 0
    assert int((tc == 0).sum()) > 0
    g_accum = torch.randn(accum.shape, device=cuda, generator=g)
    g_t = torch.randn(tfin.shape, device=cuda, generator=g)
    args = (feat, ts, tc, ntx, nc, g_accum, g_t, tfin, ncon, accum)
    got = composite.composite_bwd(*args, t_in=t_in, tile0=tile0)
    want = composite.composite_bwd_plain(
        *args[:-1], torch.sum(g_accum * accum, dim=-1), t_in, tile0)
    torch.cuda.synchronize()
    top = float(want[:, :10].abs().max())
    assert top > 0
    torch.testing.assert_close(got[:, :10], want[:, :10], rtol=1e-4,
                               atol=1e-5 * top)
    assert torch.equal(got[:, 10:], want[:, 10:])
    assert torch.equal(got, composite.composite_bwd(*args, t_in=t_in,
                                                    tile0=tile0))
    loose = composite.composite_bwd(*args, t_in=t_in, tile0=tile0,
                                    zero_fill=False)
    pair = composite._visited_pairs(ts, nvis)
    assert torch.equal(loose[pair // 128, :11, pair % 128],
                       got[pair // 128, :11, pair % 128])
    evals = torch.zeros(3, dtype=torch.int64, device=cuda)
    counted = composite.composite_bwd(*args, t_in=t_in, tile0=tile0,
                                      evals=evals)
    assert torch.equal(counted, got)
    assert int(evals[1]) == int(nvis.sum()) and int(evals[0]) >= int(evals[2])


def _fwd_case(cuda, scene):
    """A stream for kernel D: "faint" has tiles deeper than two 64-pair
    batches and pixels that never saturate, "opaque" pixels that saturate
    within a few pairs; every fifth tile's count is 0."""
    if scene == "faint":
        feat, bins = _binned_stream(7, 3000, 200, 120, op_scale=0.15)
    else:
        feat, bins = _binned_stream(2, 1500, 70, 50, opaque=True)
    tc = bins.tile_count.clone()
    tc[::5] = 0
    return (feat.to(cuda), bins.tile_start.to(cuda), tc.to(cuda),
            bins.num_tiles_x)


def _fwd_against_plain(feat, ts, tc, ntx, nc, **kw):
    """Kernel D once, counted, against its plain version; the strip of the
    tiles from 13 on, bit for bit; two launches bit for bit. Returns the
    kernel's outputs and each tile's need."""
    evals = torch.zeros(2 + ts.numel(), dtype=torch.int64, device=ts.device)
    before = composite.FWD_KERNEL.launches
    got = composite.composite_fwd(feat, ts, tc, ntx, nc, evals=evals, **kw)
    assert composite.FWD_KERNEL.launches == before + 1
    want = composite.composite_fwd_plain(feat, ts, tc, ntx, nc, **kw)
    assert torch.equal(got[2], want[2])             # every pixel
    for g, x in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, x, atol=2e-5, rtol=0)
    assert torch.equal(got[1] < 0, want[1] < 0)
    again = composite.composite_fwd(feat, ts, tc, ntx, nc, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    t0 = 13
    sl = slice(t0, ts.numel() - 7)
    t_in = kw.get("t_in")
    part = composite.composite_fwd(
        feat, ts[sl].contiguous(), tc[sl].contiguous(), ntx, nc, tile0=t0,
        t_in=t_in[sl].contiguous() if t_in is not None else None,
        mark_done=kw.get("mark_done", False))
    assert all(torch.equal(a, b[sl]) for a, b in zip(part, got))
    need = evals[2:]
    assert int(need.sum()) == int(evals[1]) and bool((need <= tc).all())
    assert int(evals[0]) <= 256 * int(evals[1])
    return got, need


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [1, 2, 3, 4])
@pytest.mark.parametrize("scene", ["faint", "opaque"])
def test_composite_fwd_kernel_every_case(cuda, scene, nc):
    """Kernel D at every colour count: n_contrib equal to the plain
    version on every pixel, tiles of count 0, tiles deeper than a batch
    whose pixels never saturate (the tile walks its whole range), tiles
    that leave early, strips and repeats bit for bit."""
    feat, ts, tc, ntx = _fwd_case(cuda, scene)
    (acc, tfin, ncon), need = _fwd_against_plain(feat, ts, tc, ntx, nc)
    empty = tc == 0
    assert bool(empty.any()) and not need[empty].any()
    assert not acc[empty].any() and not ncon[empty].any()
    assert bool((tfin[empty] == 1.0).all())
    if scene == "faint":
        assert int(need.max()) > 2 * 64
        never = (need == tc) & (tc > 64)        # walked the whole range
        assert bool(never.any()) and bool((tfin[never] > 1e-4).all())
    else:
        assert bool(((need < tc) & (tc > 64)).any())   # left early
        assert float(tfin.median()) < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [1, 2, 3, 4])
@pytest.mark.parametrize("mark_done", [False, True])
def test_composite_fwd_kernel_t_in_every_case(cuda, nc, mark_done):
    """Kernel D continuing a transmittance: pixels that arrive done
    (<= 1e-4, or negative), tiles whose every pixel arrives done, and a
    t_in with every pixel of every tile done, which leaves every tile at
    once."""
    feat, ts, tc, ntx = _fwd_case(cuda, "faint")
    g = torch.Generator(device=cuda).manual_seed(nc)
    t_in = torch.rand((ts.numel(), 256), device=cuda, generator=g) * 0.9 + 0.1
    t_in[:, ::7] = 5e-5
    t_in[:, 1::7] *= -1.0
    t_in[3::11] = 2e-5
    kw = dict(mark_done=mark_done)
    (acc, tfin, ncon), need = _fwd_against_plain(feat, ts, tc, ntx, nc,
                                                 t_in=t_in, **kw)
    arrived = t_in <= 1e-4
    assert torch.equal(tfin[arrived].abs(), t_in[arrived].abs())
    assert not acc[arrived].any() and not ncon[arrived].any()
    assert not need[3::11].any() and bool(need.any())
    done = -t_in.abs()
    (acc, tfin, ncon), need = _fwd_against_plain(feat, ts, tc, ntx, nc,
                                                 t_in=done, **kw)
    assert not need.any() and not acc.any() and not ncon.any()
    assert torch.equal(tfin, done if mark_done else t_in.abs())


@pytest.mark.cuda
@pytest.mark.parametrize("name", F_CASES)
def test_ranksum_kernel_equals_its_model(cuda, name):
    """Kernel F on the CPU model's cases: bit for bit the model's order
    of additions, the plain version at rtol 1e-4 + atol 1e-5 of the
    largest |sum|, two launches bit-equal."""
    rows, ranks, num_out = _case(name)
    r = torch.from_numpy(rows).to(cuda)
    k = torch.from_numpy(ranks).to(cuda)
    before = segreduce.KERNEL.launches
    got = segreduce.rank_rowsum(r, k, num_out)
    assert segreduce.KERNEL.launches == before + 1
    assert torch.equal(got.cpu(),
                       torch.from_numpy(ranksum_model(rows, ranks, num_out)))
    want = segreduce.rank_rowsum_plain(r.cpu(), k.cpu(), num_out)
    top = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5 * top)
    assert torch.equal(got, segreduce.rank_rowsum(r, k, num_out))


@pytest.mark.cuda
@pytest.mark.parametrize("p_len,n_out,long_run", [
    (0, 50, 0), (1, 1, 0), (12345, 700, 0), (40000, 3000, 9000),
    (5000, 300, 5000)])
def test_ranksum_kernel_matches_plain(cuda, p_len, n_out, long_run):
    rng = np.random.default_rng(p_len)
    ranks = rng.integers(0, n_out + 1, size=p_len)
    if long_run:
        ranks[:long_run] = n_out // 3          # a run over several blocks
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
    assert torch.equal(got.cpu(), torch.from_numpy(ranksum_model(
        rows.cpu().numpy(), ranks, n_out)))
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
@pytest.mark.parametrize("n_seg,c,long_run", [
    (3000, 10, 0), (70_000, 10, 5000), (257, 3, 40), (1, 16, 0)])
def test_segsum_kernel_matches_plain(cuda, n_seg, c, long_run):
    rng = np.random.default_rng(n_seg)
    counts = rng.integers(1, 9, size=n_seg)
    counts[rng.random(n_seg) < 0.4] = 0
    counts[:3] = 0
    counts[-2:] = 0
    if long_run:
        counts[n_seg // 2] = long_run
    ends = np.cumsum(counts).astype(np.int32)
    starts = (ends - counts).astype(np.int32)
    total = max(int(ends[-1]), 1)
    rows = torch.from_numpy(rng.standard_normal((c, total)).astype(
        np.float32)).to(cuda)
    st, en = torch.from_numpy(starts).to(cuda), torch.from_numpy(ends).to(cuda)
    got = segreduce.segment_rowsum(rows, st, en)
    want = segreduce.segment_rowsum_plain(rows, st, en)
    tol = dict(rtol=1e-4, atol=1e-5 * max(float(want.abs().max()), 1.0))
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(got, segreduce.segment_rowsum(rows, st, en))
    cpu = segreduce.segment_rowsum(rows.cpu(), st.cpu(), en.cpu())
    torch.testing.assert_close(got.cpu(), cpu, **tol)
    if int(ends[-1]) > 0:
        # Bounds past the rows are clipped.
        clipped = segreduce.segment_rowsum(
            rows, st, en + 7 * (en == en[-1]).to(torch.int32))
        torch.testing.assert_close(clipped, want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 255, 1281, 40_000, 700_001])
@pytest.mark.parametrize("c", [1, 6, 8, 16])
def test_scan_rows_kernel_matches_plain(cuda, m, c):
    rng = np.random.default_rng(m + c)
    x = rng.integers(-50, 1000, size=(m, c)).astype(np.int32)
    x[rng.random((m, c)) < 0.7] = -1
    xi = torch.from_numpy(x).to(cuda)
    assert torch.equal(scan.cumsum_rows(xi), scan.cumsum_rows_plain(xi))
    assert torch.equal(scan.cummax_rows(xi), scan.cummax_rows_plain(xi))
    xf = torch.from_numpy(rng.standard_normal((m, c)).astype(
        np.float32)).to(cuda)
    assert torch.equal(scan.cummax_rows(xf), scan.cummax_rows_plain(xf))
    # Both float32 sums carry their own rounding over up to 700k terms:
    # the kernel is held against the plain version run in float64.
    got, want = scan.cumsum_rows(xf), scan.cumsum_rows_plain(xf.double())
    top = want.abs().amax(dim=0, keepdim=True)
    assert bool(((got.double() - want).abs() <= 1e-5 * top + 1e-6).all())
    assert torch.equal(got, scan.cumsum_rows(xf))



@pytest.mark.cuda
@pytest.mark.parametrize("name", G_CASES)
def test_segsum_kernel_equals_its_model(cuda, name):
    """Kernel G on the CPU model's cases: bit for bit the model's order of
    additions, the plain version at rtol 1e-4 + atol 1e-5 of the largest
    |sum|, two launches bit-equal, one device launch a call."""
    rows, starts, ends = g_case(name)
    r = torch.from_numpy(rows).to(cuda)
    st, en = torch.from_numpy(starts).to(cuda), torch.from_numpy(ends).to(cuda)
    before = segreduce.SEG_KERNEL.launches
    got = segreduce.segment_rowsum(r, st, en)
    assert segreduce.SEG_KERNEL.launches == before + 1
    assert torch.equal(got.cpu(), torch.from_numpy(
        segsum_model(rows, starts, ends)))
    want = segreduce.segment_rowsum_plain(r.cpu(), st.cpu(), en.cpu())
    top = max(float(want.abs().max()) if want.numel() else 0.0, 1.0)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5 * top)
    assert torch.equal(got, segreduce.segment_rowsum(r, st, en))
    assert _cuda.captured_launches(
        segreduce.SEG_KERNEL,
        lambda: segreduce.segment_rowsum(r, st, en)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("c", list(range(1, 17)))
def test_segsum_kernel_every_width(cuda, c):
    rng = np.random.default_rng(100 + c)
    counts = rng.integers(0, 12, 5000)
    counts[rng.random(5000) < 0.25] = 0
    counts[2000] = 3000
    ends = np.cumsum(counts).astype(np.int32)
    starts = (ends - counts).astype(np.int32)
    rows = rng.standard_normal((c, int(ends[-1]))).astype(np.float32)
    got = segreduce.segment_rowsum(torch.from_numpy(rows).to(cuda),
                                   torch.from_numpy(starts).to(cuda),
                                   torch.from_numpy(ends).to(cuda))
    assert torch.equal(got.cpu(), torch.from_numpy(
        segsum_model(rows, starts, ends)))


ROWSCAN_SHAPES = [(c, m) for c in range(1, 17)
                  for m in (1, h_rows(c) - 3, 5 * h_rows(c) + 17)] + \
    [(6, 700_001), (8, 700_001), (16, 700_001), (1, 2_000_003)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,m", ROWSCAN_SHAPES)
def test_scan_rows_kernel_equals_its_model(cuda, c, m):
    """Kernel H: bit for bit its numpy model (the float32 sum too), the
    plain version exact for int32 and float32 max, the float32 sum at
    rtol 1e-5 of the column's largest against float64; two launches
    bit-equal; one device launch a call, counted once."""
    rng = np.random.default_rng(m + c)
    xi = rng.integers(-50, 1000, size=(m, c)).astype(np.int32)
    xi[rng.random((m, c)) < 0.7] = -1
    xf = rng.standard_normal((m, c)).astype(np.float32)
    for x in (xi, xf):
        xd = torch.from_numpy(x).to(cuda)
        for opname, fn, plain in (
                ("add", scan.cumsum_rows, scan.cumsum_rows_plain),
                ("max", scan.cummax_rows, scan.cummax_rows_plain)):
            before = scan.ROWS_KERNEL.launches
            got = fn(xd)
            assert scan.ROWS_KERNEL.launches == before + 1
            model, _ = rowscan_model(x, opname)
            assert torch.equal(got.cpu(), torch.from_numpy(model)), \
                (opname, x.dtype)
            if x.dtype == np.float32 and opname == "add":
                want = plain(xd.double())
                top = want.abs().amax(dim=0, keepdim=True)
                assert bool(((got.double() - want).abs()
                             <= 1e-5 * top + 1e-6).all())
            else:
                assert torch.equal(got, plain(xd))
            assert torch.equal(fn(xd), got)
            assert _cuda.captured_launches(scan.ROWS_KERNEL,
                                           lambda: fn(xd)) == 1
    # A view that starts off a 16-byte boundary takes the scalar loads.
    if m > 2:
        xv = torch.from_numpy(xf).to(cuda).reshape(-1)[1:1 + (m - 1) * c]
        xv = xv.view(m - 1, c)
        assert torch.equal(scan.cummax_rows(xv),
                           scan.cummax_rows(xv.clone()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,op", [("int32", "add"), ("int32", "max"),
                                      ("float32", "max"), ("float32", "add")])
def test_scan_rows_repeats_on_one_stream_and_on_two(cuda, dtype, op):
    """200 launches give one result, and so do launches interleaved on two
    streams (each stream has a scratch of its own)."""
    fn = scan.cumsum_rows if op == "add" else scan.cummax_rows
    rng = np.random.default_rng(0)
    xs = []
    for i, c in enumerate((16, 6)):
        m = 600_000 - 7 * i
        x = (rng.integers(-9, 9, (m, c)).astype(np.int32) if dtype == "int32"
             else rng.standard_normal((m, c)).astype(np.float32))
        xs.append(torch.from_numpy(x).to(cuda))
    want = [fn(x) for x in xs]
    torch.cuda.synchronize()
    for _ in range(200):
        assert torch.equal(fn(xs[0]), want[0])
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(100):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(fn(xs[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for o in outs[i]:
            assert torch.equal(o, want[i])
    assert len({k for k in scan._rows_scratch if k[1] in
                {st.cuda_stream for st in streams}}) == 2

def _two_window_streams(cuda, seed=0, n=3000, w=200, h=120, opaque=False):
    """A scene binned in two depth windows of equal gaussian count, on the
    card: per window (feat, bins)."""
    from street_gaussians_ns_tpu_torch.ops import tiles

    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.standard_normal((n, 2)),
                            -rng.random((n, 1)) * 8.0 - 2.0], 1)
    q = rng.standard_normal((n, 4))
    args = [torch.tensor(a, dtype=torch.float32) for a in (
        means, np.exp(rng.standard_normal((n, 3)) * 0.5 - 2.5),
        q / np.linalg.norm(q, axis=1, keepdims=True))]
    op = (torch.full((n,), 0.95) if opaque else
          torch.tensor(rng.random(n) * 0.9 + 0.05, dtype=torch.float32))
    colors = torch.tensor(rng.random((n, 4)), dtype=torch.float32)
    cam = Camera.make(100.0, 100.0, w / 2, h / 2, np.eye(3, 4), w, h,
                      device="cpu")
    p = project(*args, viewmat_from_c2w(cam.c2w), cam.fx, cam.fy, cam.cx,
                cam.cy, w, h, opacities=op)
    depth_key = torch.where(p.num_tiles_hit > 0, p.depths,
                            torch.full_like(p.depths, float("inf")))
    cols = tiles._depth_sort_cols(*(t.to(cuda) for t in (
        p.xys, p.conics, p.tile_box, depth_key, colors, op)), False)
    out = []
    for s in range(2):
        bins, feats = tiles._bin_sorted(cols, (s * (n // 2), n // 2), w, h,
                                        16, 1 << 15, 1 << 14)
        assert 0 < int(bins.num_pairs) <= 1 << 15
        out.append((composite.pack_feat_cols(feats, 1 << 15), bins))
    return out, -(-w // 16)


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True])
def test_composite_kernels_with_t_in_match_plain(cuda, opaque):
    (w0, w1), ntx = _two_window_streams(cuda, opaque=opaque)
    _, t_in, _ = composite.composite_fwd(w0[0], w0[1].tile_start,
                                         w0[1].tile_count, ntx, 4)
    t_in = t_in.clone()
    t_in[:, ::7] = 5e-5                  # pixels that arrive done
    t_in[:, 1::7] *= -1.0                # ... latched by an earlier window
    t_in[::5] = 2e-5                     # tiles whose every pixel has
    feat, bins = w1
    ts, tc = bins.tile_start, bins.tile_count
    before = composite.FWD_KERNEL.mode_launches.get("t_in", 0)
    acc_k, t_k, n_k = composite.composite_fwd(feat, ts, tc, ntx, 4,
                                              t_in=t_in)
    assert composite.FWD_KERNEL.mode_launches["t_in"] == before + 1
    acc_p, t_p, n_p = composite.composite_fwd_plain(feat, ts, tc, ntx, 4,
                                                    t_in)
    assert torch.equal(n_k, n_p)
    torch.testing.assert_close(acc_k, acc_p, rtol=0, atol=2e-5)
    torch.testing.assert_close(t_k, t_p, rtol=0, atol=2e-5)
    arrived = t_in <= 1e-4
    assert torch.equal(t_k[arrived], t_in[arrived].abs())
    assert not acc_k[arrived].any() and not n_k[arrived].any()
    # mark_done: the sign of T_final says which pixels are done.
    _, t_m, n_m = composite.composite_fwd(feat, ts, tc, ntx, 4, t_in=t_in,
                                          mark_done=True)
    _, t_mp, _ = composite.composite_fwd_plain(feat, ts, tc, ntx, 4, t_in,
                                               mark_done=True)
    assert torch.equal(t_m.abs(), t_k) and torch.equal(n_m, n_k)
    assert torch.equal(t_m < 0, t_mp < 0)
    assert bool((t_m[arrived] <= 0).all()) and bool((t_m > 0).any())
    # A tile of count 0 writes T_final = t_in.
    zero = torch.zeros_like(tc)
    _, t_z, n_z = composite.composite_fwd(feat, ts, zero, ntx, 4, t_in=t_in)
    assert torch.equal(t_z, t_in.abs()) and not n_z.any()

    rng = np.random.default_rng(1)
    g_accum = torch.from_numpy(rng.standard_normal(tuple(acc_k.shape)).astype(
        np.float32)).to(cuda)
    g_t = torch.from_numpy(rng.standard_normal(tuple(t_k.shape)).astype(
        np.float32)).to(cuda)
    args = (feat, ts, tc, ntx, 4, g_accum, g_t, t_k, n_k, acc_k)
    got = composite.composite_bwd(*args, t_in=t_in)
    want = composite.composite_bwd_plain(
        *args[:-1], torch.sum(g_accum * acc_k, dim=-1), t_in)
    top = float(want[:, :10].abs().max())
    assert top > 0
    torch.testing.assert_close(got[:, :10], want[:, :10], rtol=1e-4,
                               atol=1e-5 * top)
    assert torch.equal(got[:, 10:], want[:, 10:])
    assert torch.equal(got, composite.composite_bwd(*args, t_in=t_in))


@pytest.mark.cuda
def test_composite_kernels_tile0_strip_is_bit_equal(cuda):
    (w0, _), ntx = _two_window_streams(cuda)
    feat, bins = w0
    ts, tc = bins.tile_start, bins.tile_count
    full = composite.composite_fwd(feat, ts, tc, ntx, 4)
    rng = np.random.default_rng(2)
    g_accum = torch.from_numpy(rng.standard_normal(
        tuple(full[0].shape)).astype(np.float32)).to(cuda)
    g_t = torch.from_numpy(rng.standard_normal(
        tuple(full[1].shape)).astype(np.float32)).to(cuda)
    gfull = composite.composite_bwd(feat, ts, tc, ntx, 4, g_accum, g_t,
                                    full[1], full[2], full[0])
    gsum = torch.zeros_like(gfull)
    n = ts.numel()
    for t0 in range(0, n, 17):
        sl = slice(t0, min(t0 + 17, n))
        part = composite.composite_fwd(feat, ts[sl].contiguous(),
                                       tc[sl].contiguous(), ntx, 4, tile0=t0)
        for a, b in zip(part, full):
            assert torch.equal(a, b[sl])
        gsum += composite.composite_bwd(
            feat, ts[sl].contiguous(), tc[sl].contiguous(), ntx, 4,
            g_accum[sl].contiguous(), g_t[sl].contiguous(), part[1], part[2],
            part[0], tile0=t0)
    assert torch.equal(gsum[:, :10], gfull[:, :10])


@pytest.mark.cuda
def test_secondary_routes_on_the_card_match_the_cpu(cuda):
    """The strip route of the sharded trainer, on the card against the
    CPU."""
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
    ntx, nty = -(-w // 16), -(-h // 16)
    res = {}
    for dev in ("cpu", cuda):
        pd = dataclasses.replace(p, **{
            f.name: getattr(p, f.name).to(dev)
            for f in dataclasses.fields(p)})
        leaves = [t.to(dev).requires_grad_(True)
                  for t in (p.xys, p.conics, colors, op)]
        pd = dataclasses.replace(pd, xys=leaves[0], conics=leaves[1])
        parts = [composite.composite_tiles_fused(
            pd, leaves[2], leaves[3], t0, 20, w, h, 1 << 15)
            for t0 in range(0, ntx * nty, 20)]
        img = composite._tiles_to_image(
            torch.cat([a for a, _, _ in parts])[:ntx * nty], ntx, nty, w, h)
        alpha = composite._tiles_to_image(
            torch.cat([a for _, a, _ in parts])[:ntx * nty], ntx, nty, w, h)
        loss = (img - target.to(dev)).abs().mean() + 0.3 * (alpha ** 2).mean()
        res[str(dev)] = (img.detach().cpu(), [
            g.cpu() for g in torch.autograd.grad(loss, leaves)])
    torch.testing.assert_close(res[str(cuda)][0], res["cpu"][0], rtol=0,
                               atol=2e-5)
    for name, a, b in zip(("xys", "conics", "colors", "opac"),
                          res[str(cuda)][1], res["cpu"][1]):
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
    tab = torch.zeros((4, 10), device=cuda)
    box = torch.zeros((4, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                 # a column stride of 2
        tiles._row_trim_counts(tab[:, 2:8:2], tab[:, 0:2], box, 16, 4,
                               tab[:, 5].contiguous())
    with pytest.raises(ValueError):                 # box not contiguous
        tiles._row_trim_counts(tab[:, 2:5], tab[:, 0:2],
                               torch.cat([box, box], 1)[:, ::2], 16, 4,
                               tab[:, 5].contiguous())


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: building a kernel raises, it never falls back."""

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

    paths = {k.library_path() for k in _cuda.KERNELS}
    assert len(paths) == len(_cuda.KERNELS) == 12
    for k in _cuda.KERNELS:
        p = k.library_path()
        assert p.parent == _cuda.BUILD_DIR and p.suffix == ".so"
        assert p.name.startswith(k.source.split(".")[0] + "-")
        assert (_cuda.CSRC / k.source).exists()


@pytest.mark.parametrize("view,error", [
    ("contiguous", None),
    ("columns of a table", None),       # rows 10 floats apart
    ("one row", None),
    ("no rows", None),
    ("column stride 2", ValueError),
    ("flat", ValueError),
    ("float64", TypeError),
])
def test_check_takes_strided_rows_with_adjacent_columns(view, error):
    """_cuda.check(strided_rows=True), as kernel I's wrapper checks the
    conics and centres: rows may lie apart, a row's values may not."""
    tab = torch.arange(40, dtype=torch.float32).reshape(4, 10)
    t = {"contiguous": tab[:, :3].contiguous(),
         "columns of a table": tab[:, 2:5], "one row": tab[:1, 2:5],
         "no rows": tab[:0, 2:5], "column stride 2": tab[:, 2:8:2],
         "flat": tab[:, 2:5].reshape(-1)[:3],
         "float64": tab[:, 2:5].double()}[view]
    n = t.shape[0] if t.dim() == 2 else 3
    if error is None:
        _cuda.check(t, "conics", torch.float32, shape=(n, 3),
                    strided_rows=True)
    else:
        with pytest.raises(error):
            _cuda.check(t, "conics", torch.float32, strided_rows=True)
    if view == "columns of a table":
        with pytest.raises(ValueError):      # the default wants contiguous
            _cuda.check(t, "conics", torch.float32, shape=(4, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("n,width,height,tile", [
    (1_179_648, 1600, 1056, 16),    # the cells' N: max_h 66
    (1_179_648, 480, 270, 16),      # max_h 17
    (0, 1600, 1056, 16),
    (1, 1600, 1056, 16),
    (255, 1600, 1056, 16),
    (257, 480, 270, 16),
    (70_001, 1600, 1056, 12),       # a tile size whose reciprocal rounds
])
def test_row_trim_kernel_matches_plain(cuda, n, width, height, tile):
    """Kernel I against the plain trim on the card, bit for bit, on
    strided views of an (N, 10) table as _trim_full passes them; one
    launch a call."""
    tab, box = trim_table(np.random.default_rng(n + width), n, width,
                          height, tile)
    tab = torch.from_numpy(tab).to(cuda)
    box = torch.from_numpy(box).to(cuda)
    q = coverage_q(tab[:, 5])
    max_h = -(-height // tile)
    args = (tab[:, 2:5], tab[:, 0:2], box, tile, max_h, q)
    before = tiles.TRIM_KERNEL.launches
    got = tiles._row_trim_counts(*args)
    assert tiles.TRIM_KERNEL.launches == before + 1
    want = tiles._row_trim_counts_plain(*args)
    for name, g, w in zip(("first", "last", "count"), got, want):
        assert g.dtype == torch.int32 and g.shape == (n,)
        assert torch.equal(g, w), (
            name, int((g != w).sum()), torch.nonzero(g != w)[:8].tolist())
    if n >= 70_000:
        assert int(want[2].sum()) > n and int((want[0] > 0).sum()) > 0
        assert _cuda.captured_launches(
            tiles.TRIM_KERNEL, lambda: tiles._row_trim_counts(*args)) == 1


@pytest.mark.cuda
def test_floor_int_on_the_card_saturates_as_the_explicit_form(cuda):
    """core/projection._floor_int's card branch (the bare conversion)
    against its explicit CPU form: NaN to 0, values past int32's ends
    saturated, every finite value in range unchanged."""
    edges = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e38,
                          -3e38, 2.0 ** 31, -2.0 ** 31, 2.0 ** 31 - 128,
                          -2.0 ** 31 - 256, 0.5, -0.5, -1e-30, 1e-30])
    x = torch.cat([edges, torch.randn(100_000) * 4e9,
                   torch.randn(100_000) * 3000.0])
    got = _floor_int(x.to(cuda)).cpu()
    want = _floor_int(x)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want), torch.nonzero(got != want)[:8].tolist()
    assert want[:7].tolist() == [0, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1,
                                 -2 ** 31, 2 ** 31 - 1, -2 ** 31]


@pytest.mark.cuda
def test_binning_same_with_kernel_and_plain_trim(cuda, monkeypatch):
    """bin_and_pack and count_pairs on the card give the same TileBins,
    feature columns and counts with kernel I as with the plain trim."""
    rng = np.random.default_rng(7)
    n, w, h = 60_000, 640, 360
    means = np.concatenate([rng.standard_normal((n, 2)) * 2.0,
                            -rng.random((n, 1)) * 8.0 - 2.0], 1)
    qt = rng.standard_normal((n, 4))
    args = [torch.tensor(a, dtype=torch.float32, device=cuda) for a in (
        means, np.exp(rng.standard_normal((n, 3)) * 0.5 - 2.5),
        qt / np.linalg.norm(qt, axis=1, keepdims=True))]
    op = torch.tensor(rng.random(n) * 0.9 + 0.05, dtype=torch.float32,
                      device=cuda)
    colors = torch.tensor(rng.random((n, 4)), dtype=torch.float32,
                          device=cuda)
    cam = Camera.make(300.0, 300.0, w / 2, h / 2, np.eye(3, 4), w, h,
                      device=cuda)
    p = project(*args, viewmat_from_c2w(cam.c2w), cam.fx, cam.fy, cam.cx,
                cam.cy, w, h, opacities=op)
    depth_key = torch.where(p.num_tiles_hit > 0, p.depths,
                            torch.full_like(p.depths, float("inf")))

    def run():
        bins, feats = bin_and_pack(p.xys, p.conics, p.tile_box, depth_key,
                                   colors, op, w, h, 16, 1 << 20)
        return bins, feats, tiles.count_pairs(p, w, h, 16, opacities=op)

    before = tiles.TRIM_KERNEL.launches
    kb, kf, kc = run()
    assert tiles.TRIM_KERNEL.launches == before + 2
    monkeypatch.setattr(tiles, "_row_trim_counts",
                        tiles._row_trim_counts_plain)
    pb, pf, pc = run()
    assert tiles.TRIM_KERNEL.launches == before + 2
    assert 0 < int(kb.num_pairs) <= 1 << 20
    for name in tiles._TENSOR_FIELDS:
        a, b = getattr(kb, name), getattr(pb, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert len(kf) == len(pf) == 11
    for i, (a, b) in enumerate(zip(kf, pf)):
        assert torch.equal(a, b), f"feature column {i}"
    assert [int(v) for v in kc] == [int(v) for v in pc]


# ---------------------------------------------------------------------------
# Kernel J: the SH colour.
# ---------------------------------------------------------------------------

def _same(a, b) -> bool:
    """Equal values, NaN where NaN (the sign of a zero not compared)."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _sh_on(dev, n, degree, seed=0, rows_from=0, means_cols=3):
    """Kernel J's inputs on `dev`: row views [rows_from, rows_from + n) of
    larger tables, as compose's flat tensors are sliced, with the centres
    in the first three of `means_cols` columns."""
    m, dc, rest, c2w = sh_inputs(np.random.default_rng(seed + n), n, degree)
    pad = lambda a: np.concatenate([np.zeros((rows_from,) + a.shape[1:],
                                             np.float32), a])
    mt = np.zeros((rows_from + n, means_cols), np.float32)
    mt[rows_from:, :3] = m
    means = torch.from_numpy(mt).to(dev)[rows_from:, :3]
    dc_t = torch.from_numpy(pad(dc)).to(dev)[rows_from:]
    rest_t = torch.from_numpy(pad(rest)).to(dev)[rows_from:]
    cam = Camera.make(500.0, 500.0, 320.0, 240.0, c2w, 640, 480, device=dev)
    return means, dc_t, rest_t, cam


def _sh_case(cuda, means, dc, rest, cam, active):
    """Kernel J against the plain versions on one input, both ways; one
    launch a call each way by the counter. The gradients equal autograd's
    through the k-order formulation everywhere, and through the einsum
    wherever its sum is on the kernel's side of the clamp at 0: where the
    two orders of addition straddle 0, each follows its own forward."""
    center = cam.c2w[:3, 3]
    kd, kr, od, orr, pd, pr = (t.clone().requires_grad_(True)
                               for t in (dc, rest) * 3)
    k = sh_colors.SH_KERNEL
    before, before_bwd = k.launches, k.mode_launches.get("bwd", 0)
    got = sh_colors.sh_colors_cuda(means, kd, kr, center, active)
    assert k.launches == before + 1
    ordered = sh_k_order(means, od, orr, center, active)
    assert _same(got, ordered)
    plain = splatfacto._sh_colors_plain(means, pd, pr, cam, active)
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    fin = torch.isfinite(plain)
    torch.testing.assert_close(got[fin], plain[fin], rtol=0.0, atol=2e-6)
    g = torch.randn(got.shape, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(means.shape[0]))
    g_kd, g_kr = torch.autograd.grad(got, (kd, kr), g)
    assert k.launches == before + 2
    assert k.mode_launches.get("bwd", 0) == before_bwd + 1
    g_od, g_or = torch.autograd.grad(ordered, (od, orr), g,
                                     allow_unused=True)
    if g_or is None:                         # degree 0: no rest
        g_or = torch.zeros_like(orr)
    assert _same(g_kd, g_od) and _same(g_kr, g_or)
    # The einsum's value before the clamp, as _sh_colors_plain forms it.
    d = means - center
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-12)
    v_plain = eval_sh(active, d, torch.cat([dc[:, None], rest], 1)) + 0.5
    v_kernel = sh_k_order(means, dc, rest, center, active, clamp=False)
    side = (v_plain >= 0) == (v_kernel >= 0)
    assert bool((v_plain[~side].abs() <= 2e-6).all())
    g_pd, g_pr = torch.autograd.grad(plain, (pd, pr), g)
    assert _same(g_kd[side], g_pd[side])
    assert _same(g_kr.transpose(0, 1)[:, side], g_pr.transpose(0, 1)[:, side])
    return got, g, g_kd, g_kr


@pytest.mark.cuda
@pytest.mark.parametrize("n,degree", [
    (4_587_520, 3),     # the Waymo segment's slots: 2^22 + 12 x 2^15
    (1_179_648, 3),     # the flagship's
    (0, 3), (1, 3), (255, 3), (257, 3),
    (257, 0), (257, 1), (257, 2), (70_001, 4),
])
def test_sh_colors_kernel_matches_plain(cuda, n, degree):
    """Kernel J at every active degree up to its own: colours bit-equal
    to the k-order formulation and within 2e-6 of the einsum, gradients
    bit-equal to autograd's through the plain version; one device launch
    a call each way."""
    means, dc, rest, cam = _sh_on(cuda, n, degree)
    for active in range(degree + 1) if n < 1_000_000 else (degree,):
        _sh_case(cuda, means, dc, rest, cam, active)
    if n > 0:
        kd = dc.clone().requires_grad_(True)
        center = cam.c2w[:3, 3]
        assert _cuda.captured_launches(
            sh_colors.SH_KERNEL, lambda: sh_colors.sh_colors_cuda(
                means, kd, rest, center, degree)) == 1
        _, mask = sh_colors.sh_fwd(means, dc, rest, center, degree, True)
        g = torch.ones((n, 3), device=cuda)
        assert _cuda.captured_launches(
            sh_colors.SH_KERNEL, lambda: sh_colors.sh_bwd(
                means, center, rest.shape[1] + 1, degree, mask, g)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows_from,means_cols", [(1, 3), (4, 4), (7, 10)])
def test_sh_colors_kernel_on_views(cuda, rows_from, means_cols):
    """Row views of larger tables, as compose's flat tensors are sliced
    (rest 180 bytes a row, so a view 16-byte aligned or not), and the
    centres as a column view of a wider table: the same bits as on
    contiguous copies."""
    means, dc, rest, cam = _sh_on(cuda, 3001, 3, rows_from=rows_from,
                                  means_cols=means_cols)
    got, g, g_dc, g_rest = _sh_case(cuda, means, dc, rest, cam, 3)
    copies = [t.contiguous() for t in (means, dc, rest)]
    assert means.is_contiguous() == (means_cols == 3)
    assert (rest.data_ptr() % 16 == 0) == (rows_from % 4 == 0)
    got2, _, g_dc2, g_rest2 = _sh_case(cuda, *copies, cam, 3)
    assert _same(got, got2) and _same(g_dc, g_dc2) and _same(g_rest, g_rest2)


@pytest.mark.cuda
def test_sh_colors_kernel_clamp_edges(cuda):
    """A pre-clamp value of exactly 0 passes its gradient, one below 0
    stops it, NaN coefficients give NaN colours (tests/sh_cases.inputs'
    edge rows, the first 32), through models.splatfacto.sh_colors."""
    means, dc, rest, cam = _sh_on(cuda, 64, 3)
    kd, kr = (t.clone().requires_grad_(True) for t in (dc, rest))
    cfg = splatfacto.SplatfactoConfig()
    rgb = splatfacto.sh_colors(means, kd, kr, cam, 30_000, cfg)
    g = torch.full_like(rgb, 2.0)
    g_dc, g_rest = torch.autograd.grad(rgb, (kd, kr), g)
    c0 = torch.tensor(0.28209479177387814, dtype=torch.float32)
    for i in range(0, 32, 8):                # v exactly 0
        assert torch.equal(rgb[i], torch.zeros(3, device=cuda))
        assert torch.equal(g_dc[i].cpu(), (c0 * 2.0).expand(3))
    for i in range(1, 32, 8):                # v below 0
        assert torch.equal(rgb[i], torch.zeros(3, device=cuda))
        assert not g_dc[i].any() and not g_rest[i].any()
    for i in range(2, 32, 8):                # NaN on the last basis
        assert bool(torch.isnan(rgb[i, i % 3]))
        assert not bool(torch.isnan(g_dc[i]).any())   # clamp stops it
    for i in range(3, 32, 8):                # NaN DC
        assert bool(torch.isnan(rgb[i, (i + 1) % 3]))


@pytest.mark.parametrize("bad,error", [
    ("dc float64", TypeError),
    ("means (N, 4)", ValueError),
    ("dc column stride 2", ValueError),
    ("rest not contiguous", ValueError),
    ("rest K = 15", ValueError),
    ("rest (N, 15, 2)", ValueError),
    ("rest rows", ValueError),
    ("center (4,)", ValueError),
    ("center float64", TypeError),
    ("mask int32", TypeError),
    ("mask rows", ValueError),
    ("grad (N, 4)", ValueError),
    ("grad float64", ValueError),
])
def test_sh_colors_wrapper_raises_on_bad_input(bad, error):
    """Kernel J's wrappers check dtypes, shapes and strides before any
    pointer reaches C (no launch, no build: these run on the CPU)."""
    n = 6
    tab = torch.zeros((n, 8))
    a = dict(means=tab[:, :3], dc=tab[:, 3:6], rest=torch.zeros((n, 15, 3)),
             center=torch.zeros((3, 4))[:, 3])
    b = dict(mask=torch.zeros((n,), dtype=torch.uint8),
             grad=torch.zeros((n, 3)))
    fix = {
        "dc float64": ("dc", tab[:, 3:6].double()),
        "means (N, 4)": ("means", tab[:, :4]),
        "dc column stride 2": ("dc", tab[:, 2:8:2]),
        "rest not contiguous": ("rest", torch.zeros((n, 3, 15)).mT),
        "rest K = 15": ("rest", torch.zeros((n, 14, 3))),
        "rest (N, 15, 2)": ("rest", torch.zeros((n, 15, 2))),
        "rest rows": ("rest", torch.zeros((n + 1, 15, 3))),
        "center (4,)": ("center", torch.zeros(4)),
        "center float64": ("center", torch.zeros(3, dtype=torch.float64)),
        "mask int32": ("mask", torch.zeros((n,), dtype=torch.int32)),
        "mask rows": ("mask", torch.zeros((n + 1,), dtype=torch.uint8)),
        "grad (N, 4)": ("grad", torch.zeros((n, 4))),
        "grad float64": ("grad", torch.zeros((n, 3), dtype=torch.float64)),
    }
    key, val = fix[bad]
    (a if key in a else b)[key] = val
    before = sh_colors.SH_KERNEL.launches
    with pytest.raises(error):
        if key in b:
            sh_colors.sh_bwd(a["means"], a["center"], 16, 3, b["mask"],
                             b["grad"])
        else:
            sh_colors.sh_fwd(a["means"], a["dc"], a["rest"], a["center"], 3,
                             True)
    assert sh_colors.SH_KERNEL.launches == before


# ---------------------------------------------------------------------------
# Kernel K: Adam over every leaf of every group in one launch.
# ---------------------------------------------------------------------------

def _bits(a, b) -> bool:
    """The same float32 bits (zeros' signs and NaNs included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _k_leaf(dev, gen, shape, mask_dims, offset, poison):
    """(p, g, m, v, active) of one leaf on `dev`: each tensor a view
    `offset` floats into a buffer of its own (so 16-byte aligned or not),
    one row in 16 and a random quarter inactive where the leaf has a mask
    over its first `mask_dims` axes, NaN, inf and -inf gradients in some
    inactive rows when `poison`."""
    n = int(np.prod(shape))

    def view(scale, positive=False):
        buf = torch.randn(n + offset, generator=gen, device=dev) * scale
        buf = buf.abs() if positive else buf
        return buf[offset:].view(shape)

    p, g, m = view(1.0), view(0.1), view(1e-3)
    v = view(1e-3, True) ** 2 if offset == 0 else view(1e-6, True)
    active = None
    if mask_dims:
        active = torch.rand(shape[:mask_dims], generator=gen,
                            device=dev) > 0.25
        active.view(-1)[15::16] = False
        if poison:
            rows = (~active).nonzero()
            for i, r in enumerate(rows[:30]):
                g[tuple(r)] = (float("nan"), float("inf"),
                               -float("inf"))[i % 3]
    return p, g, m, v, active


def _k_groups(dev, spec, count, offset=0, poison=True, seed=0):
    """[(AdamGroup, grads)] from spec = [(group, {key: (shape, mask
    dims)})] at Adam step count + 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for name, leaves in spec:
        cfg = opt.DEFAULT_GROUPS[name]
        built = {k: _k_leaf(dev, gen, shape, md, offset, poison)
                 for k, (shape, md) in leaves.items()}
        pick = lambda i: {k: b[i] for k, b in built.items()}  # noqa: E731
        masked = any(b[4] is not None for b in built.values())
        state = opt.AdamState(mu=pick(2), nu=pick(3), count=count)
        grads = pick(1)
        out.append((opt.AdamGroup(grads, state, pick(0),
                                  opt.schedule(cfg, 3600 + count), cfg,
                                  pick(4) if masked else None), grads))
    return out


def _flagship_spec():
    """The 16 leaves of a scene_graph_1m state: 2^20 background slots,
    4 vehicles x 2^15 with Fourier dim 5, SH degree 3, the 1024 sky, bbox
    deltas over 10 frames."""
    n, o, cap = 2 ** 20, 4, 2 ** 15
    tails = {"means": (3,), "scales": (3,), "quats": (4,),
             "features_dc": (1, 3), "features_rest": (15, 3),
             "opacities": (1,)}
    spec = [(name, {"bg": ((n,) + t, 1),
                    "obj": ((o, cap) + ((5, 3) if name == "features_dc"
                                        else t), 2)})
            for name, t in tails.items()]
    spec.append(("sky_sphere", {"env": ((6, 1024, 1024, 3), 0)}))
    spec.append(("bbox_opt", {"delta_center": ((10, o, 3), 0),
                              "delta_yaw": ((10, o), 0),
                              "delta_rot": ((10, o, 3), 0)}))
    return spec


def _views_spec():
    """Leaves of 1, 3, 5, 3601 and 70,001 floats, rows of 1, 3 and 45
    floats under a mask, whose numel is no multiple of 4 (a vector leaf's
    tail)."""
    return [("means", {"a": ((1,), 0), "b": ((3,), 1), "c": ((5,), 0),
                       "d": ((3601,), 1)}),
            ("features_rest", {"e": ((1556, 15, 3), 1),
                               "f": ((70_001,), 0)}),
            ("scales", {"g": ((1201, 3), 1)})]


def _many_spec(n_leaves=32):
    """n_leaves leaves of 1 to 700 rows of 1, 3, 4 or 45 floats, every
    other one masked, over seven groups."""
    rng = np.random.default_rng(7)
    names = ("means", "scales", "quats", "features_dc", "features_rest",
             "opacities", "sky_sphere")
    return [(names[i % len(names)],
             {f"l{i}": ((int(rng.integers(1, 700)),
                         int(rng.choice([1, 3, 4, 45]))), i % 2)})
            for i in range(n_leaves)]


def _k_case(stepping):
    """Kernel K against the plain version on the card, bit for bit, one
    device launch by the counter and by capture."""
    before = adam.ADAM_KERNEL.launches
    got = opt._step_kernel(stepping)
    assert adam.ADAM_KERNEL.launches == before + 1
    want = opt._step_plain(stepping)
    for (gp, gs), (wp, ws), (group, _) in zip(got, want, stepping):
        assert gs.count == ws.count == group.state.count + 1
        for tree_g, tree_w in ((gp, wp), (gs.mu, ws.mu), (gs.nu, ws.nu)):
            for a, b in zip(opt._leaves(tree_g), opt._leaves(tree_w)):
                assert _bits(a, b)
                assert bool(torch.isfinite(a).all())
    assert _cuda.captured_launches(
        adam.ADAM_KERNEL, lambda: opt._step_kernel(stepping)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("count", [0, 3600])
def test_adam_kernel_matches_plain_on_the_flagship_leaves(cuda, count):
    """All 16 leaves of a scene_graph_1m state in one launch at Adam steps
    1 and 3601, inactive rows holding NaN and inf gradients: p', m', v'
    equal the plain version's (the row mask, then _adam_plain) on the card
    bit for bit."""
    stepping = _k_groups(cuda, _flagship_spec(), count)
    assert sum(len(g.state.mu) for g, _ in stepping) == 16
    _k_case(stepping)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_adam_kernel_on_views_and_tails(cuda, offset):
    """Leaves whose tensors start 0, 4 or 8 bytes into their buffers (the
    16-byte and the one-float path), numel no multiple of 4, rows of 1, 3
    and 45 floats under a mask: the same bits as the plain version."""
    stepping = _k_groups(cuda, _views_spec(), 41, offset=offset, seed=offset)
    p = stepping[0][0].params["d"]
    assert (p.data_ptr() % 16 == 0) == (offset == 0)
    _k_case(stepping)


@pytest.mark.cuda
def test_adam_kernel_takes_a_table_of_32_leaves(cuda):
    """The largest table, 32 leaves of seven groups, half of them masked,
    in one launch."""
    stepping = _k_groups(cuda, _many_spec(32), 3600, seed=3)
    _k_case(stepping)


@pytest.mark.cuda
def test_adam_kernel_once_a_train_step(cuda):
    """The main path: a scene-graph train step launches K once and steps
    16 leaves (counter step.adam_leaves), a Splatfacto step once and 7;
    the step's own gradients reach K without a copy (the whole Adam call
    enqueues one device launch)."""
    import dataclasses

    import test_torch_tracing as tt
    from street_gaussians_ns_tpu_torch.engine import scene_train_step as sts
    from street_gaussians_ns_tpu_torch.utils import profiling
    scene, splat, batch = tt._scene("cuda"), tt._splat("cuda"), tt._batch(
        "cuda")
    profiling.reset()
    profiling.enable(True)
    try:
        for step, leaves in ((lambda: tt._scene_step(scene, batch), 16),
                             (lambda: tt._splat_step(splat, batch), 7)):
            profiling.reset()
            before = adam.ADAM_KERNEL.launches
            step()
            assert adam.ADAM_KERNEL.launches == before + 1
            snap = profiling.snapshot()["step.adam_leaves"]
            assert snap == {"count": 1, "total": leaves,
                            "parent": "step.adam"}
    finally:
        profiling.enable(False)
        profiling.reset()
    store, tracks, cfg, rcfg, cams = scene
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = dataclasses.replace(sts.init_scene_train_state(store, gen),
                                step=3600)
    *_, g = sts.scene_loss_and_grads(state, tracks, cams[0], batch, cfg,
                                     rcfg, subset_accs=False)
    assert _cuda.captured_launches(adam.ADAM_KERNEL, lambda: sts.scene_adam(
        state.store, state.opt, g["gauss"], g["env_map"], g["bbox"],
        state.step)) == 1


@pytest.mark.cuda
def test_pvg_step_on_the_card_matches_the_cpu(cuda):
    """The PVG model's train step (models.pvg: the temporal transform's
    Function, kernels A-F, I and J, then K over its ten leaves in one
    launch) on the card against its CPU path from the same tiny cloud,
    camera time, target and sky jitter: the loss and every leaf's
    gradient."""
    import test_torch_pvg as tp
    from benchmark import pvg3
    from street_gaussians_ns_tpu_torch.engine import train_step as ts
    from street_gaussians_ns_tpu_torch.utils import profiling
    sc = pvg3.make_scene(tp.SEED, tp.CFG, "cpu")
    g = 2 * 6 + 3                      # camera 3, frame 3 of tp.CFG's 6
    got = {}
    for dev in ("cpu", cuda):
        state = tp._state({k: v.to(dev) for k, v in sc.items()})
        cam, _ = tp._cameras(g, dev)
        total, _, _, _, grads = ts.loss_and_grads(
            state, cam, tp._batch(g, dev), tp.SPLAT, tp.RCFG,
            jitter=tp._jitter().to(dev), pvg=tp.PVG)
        got[str(dev)] = (float(total), {
            k: v.cpu() for k, v in {**grads["params"],
                                    "env_map": grads["env_map"]}.items()})
    (lc, gc), (lg, gg) = got["cpu"], got[str(cuda)]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for k, b in gc.items():
        top = float(b.abs().max())
        assert top > 0, k
        torch.testing.assert_close(gg[k], b, rtol=1e-4, atol=1e-5 * top,
                                   msg=lambda m: f"{k}: {m}")
    state = tp._state({k: v.to(cuda) for k, v in sc.items()})
    cam, _ = tp._cameras(g, cuda)
    batch = tp._batch(g, cuda)
    profiling.reset()
    profiling.enable(True)
    try:
        before = adam.ADAM_KERNEL.launches
        ts.train_step(state, cam, batch, tp.SPLAT, tp.RCFG,
                      jitter=tp._jitter().to(cuda), pvg=tp.PVG)
        assert adam.ADAM_KERNEL.launches == before + 1
        snap = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert snap["step.adam_leaves"]["total"] == 10
    assert snap["pvg.temporal"]["device_ms"] > 0
    assert snap["pvg.temporal_bwd"]["device_ms"] > 0


@pytest.mark.cuda
def test_deform4d_step_on_the_card_matches_the_cpu(cuda):
    """The 4DGS model's train step (models.deform4d: the planes sampled
    by grid_sample and their gradient scattered back, the decoder's GEMMs
    with TF32 off, kernels A-F, I, J and L, then K over its nine leaves in
    one launch) on the card against its CPU path from the same tiny
    cloud, field, camera time, target and sky jitter: the loss and every
    leaf's gradient, the planes, the decoder and the centres among them;
    the three spans read device time and the counter its samples."""
    import test_torch_deform4d as td
    from benchmark import deform4d3
    from street_gaussians_ns_tpu_torch.engine import train_step as ts
    from street_gaussians_ns_tpu_torch.utils import profiling
    assert not torch.backends.cuda.matmul.allow_tf32
    sc = deform4d3.make_scene(td.SEED, td.CFG, "cpu")
    g = 2 * 6 + 3                      # camera 3, frame 3 of td.CFG's 6
    got = {}
    for dev in ("cpu", cuda):
        state = td._state({k: v.to(dev) for k, v in sc.items()})
        cam, _ = td._cameras(g, dev)
        total, _, _, _, grads = ts.loss_and_grads(
            state, cam, td._batch(g, dev), td.SPLAT, td.RCFG,
            jitter=td._jitter().to(dev), deform4d=td.D4)
        got[str(dev)] = (float(total), {
            k: v.cpu() for k, v in {**grads["params"],
                                    "env_map": grads["env_map"],
                                    **grads["field"]}.items()})
    (lc, gc), (lg, gg) = got["cpu"], got[str(cuda)]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for k, b in gc.items():
        top = float(b.abs().max())
        assert top > 0, k
        torch.testing.assert_close(gg[k], b, rtol=1e-4, atol=1e-5 * top,
                                   msg=lambda m: f"{k}: {m}")
    state = td._state({k: v.to(cuda) for k, v in sc.items()})
    cam, _ = td._cameras(g, cuda)
    batch = td._batch(g, cuda)
    profiling.reset()
    profiling.enable(True)
    try:
        before = adam.ADAM_KERNEL.launches
        ts.train_step(state, cam, batch, td.SPLAT, td.RCFG,
                      jitter=td._jitter().to(cuda), deform4d=td.D4)
        assert adam.ADAM_KERNEL.launches == before + 1
        snap = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert snap["step.adam_leaves"]["total"] == 9
    for k in ("deform4d.field", "deform4d.decode", "deform4d.field_bwd"):
        assert snap[k]["device_ms"] > 0, k
    assert snap["deform4d.samples"]["total"] == 2048 * 6 * 3


@pytest.mark.cuda
def test_adam_helper_on_the_card_raises_rather_than_falls_back(cuda):
    """On CUDA tensors the helper launches K or raises: 33 leaves, a
    non-contiguous or a float64 leaf are refused with no launch."""
    import dataclasses

    before = adam.ADAM_KERNEL.launches
    with pytest.raises(ValueError, match="1 to 32 leaves"):
        opt._step_kernel(_k_groups(cuda, _many_spec(33), 1))
    stepping = _k_groups(cuda, _views_spec(), 1)
    group, grads = stepping[0]
    bad = dict(group.params, b=torch.zeros((3, 2), device=cuda)[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        opt._step_kernel([(dataclasses.replace(group, params=bad), grads)])
    bad = dict(group.params, c=group.params["c"].double())
    with pytest.raises(TypeError, match="float64"):
        opt._step_kernel([(dataclasses.replace(group, params=bad), grads)])
    assert adam.ADAM_KERNEL.launches == before


@pytest.mark.parametrize("bad,error,match", [
    ("33 leaves", ValueError, "1 to 32 leaves"),
    ("no leaves", ValueError, "1 to 32 leaves"),
    ("g not contiguous", ValueError, "contiguous"),
    ("m float64", TypeError, "float64"),
    ("v another shape", ValueError, "shape"),
    ("active uint8", TypeError, "bool"),
    ("active rows", ValueError, "shape"),
    ("hyper of 7", ValueError, "8 numbers"),
    ("cpu tensors", ValueError, "CUDA tensors"),
])
def test_adam_wrapper_raises_on_bad_input(bad, error, match):
    """Kernel K's wrapper checks the table before any pointer reaches C
    (no launch, no build: these run on the CPU)."""
    z = lambda *s: torch.zeros(s)  # noqa: E731
    h = (1e-3, 0.9, 0.1, 0.999, 1e-3, 1e-15, 10.0, 1000.0)
    leaf = [z(6, 3), z(6, 3), z(6, 3), z(6, 3),
            torch.ones(6, dtype=torch.bool), h]
    leaves = [leaf]
    fix = {
        "33 leaves": lambda: [leaf] * 33,
        "no leaves": lambda: [],
        "g not contiguous": lambda: [leaf[:1] + [z(3, 6).T] + leaf[2:]],
        "m float64": lambda: [leaf[:2] + [z(6, 3).double()] + leaf[3:]],
        "v another shape": lambda: [leaf[:3] + [z(6, 4)] + leaf[4:]],
        "active uint8": lambda: [leaf[:4] + [torch.ones(
            6, dtype=torch.uint8), h]],
        "active rows": lambda: [leaf[:4] + [torch.ones(
            5, dtype=torch.bool), h]],
        "hyper of 7": lambda: [leaf[:5] + [h[:7]]],
        "cpu tensors": lambda: leaves,
    }
    before = adam.ADAM_KERNEL.launches
    with pytest.raises(error, match=match):
        adam.adam_leaves(fix[bad]())
    assert adam.ADAM_KERNEL.launches == before


# ---------------------------------------------------------------------------
# Kernel L: the projection in one launch forward and one backward.
# ---------------------------------------------------------------------------

PROJ_FIELDS = ("xys", "depths", "radii", "conics", "comp", "num_tiles_hit",
               "tile_box")
# Kernel L's backward is held to its specification, the closed form
# ops.project._project_vjp_plain run on the card in float32, bit for bit
# (the view matrix's 12 sums, which the kernel adds in float64 over its
# blocks and the closed form in float32, within PROJ_VIEW_ATOL of their
# largest entry); the closed form in float64 to autograd's float64 gradient
# through the plain version at rtol 1e-9, atol 1e-12 of the largest element
# (the same float64 terms in other orders: within 1e-15 of it at 4.6 M
# slots); and the kernel's float32 error from that gradient to twice
# autograd's own in float32, plus 1e-9 of the largest element.
# Beside those, the kernel against autograd in float32 at rtol 1e-4 with
# atol 2e-4 of each gradient's largest element: a coarse check, since the
# two add the same terms in other orders and, where a slot's terms cancel
# (scales and quaternions of slots at the frustum clamp or the near clip,
# and at scale slots far off the frustum), either lies further from the
# float64 gradient than the slot's own largest value.
PROJ_VIEW_ATOL = 1e-6
PROJ_RTOL, PROJ_ATOL = 1e-4, 2e-4


def _proj_args(inputs, opacities=True):
    means, scales, quats, opac, vm, fx, fy, cx, cy = inputs
    return (means, scales, quats, vm, fx, fy, cx, cy, proj_cases.WIDTH,
            proj_cases.HEIGHT, 16, 0.01, opac if opacities else None)


def _proj_same(got, want):
    for f in PROJ_FIELDS:
        assert _same(getattr(got, f), getattr(want, f)), f


def _proj_grads(args, keep, cotangents, view=True, kernel=True,
                dtype=torch.float32):
    """(means, scales, quats[, viewmat]) gradients of kernel L or of
    autograd through the plain version (in `dtype`, the inputs cast to
    it), for the given cotangents of (xys, depths, conics, comp) on the
    slots `keep`."""
    means, scales, quats, vm, fx, fy, cx, cy, w, h, ts, clip, op = args
    up = lambda t: t.to(dtype) if t is not None else None  # noqa: E731
    leaves = [up(t).clone().requires_grad_(True)
              for t in (means, scales, quats)]
    vm_leaf = up(vm).clone().requires_grad_(view)
    fx, fy, cx, cy, op = map(up, (fx, fy, cx, cy, op))
    if kernel:
        p = project(*leaves, vm_leaf, fx, fy, cx, cy, w, h, ts, clip, op)
    else:
        p = _project_plain(*leaves, vm_leaf, fx, fy, cx, cy, w, h, ts, clip,
                           op, dtype=dtype)
    k = keep.to(dtype)
    outs = [p.xys, p.depths, p.conics, p.comp]
    g = [up(c) * k.reshape((-1,) + (1,) * (c.dim() - 1))
         for c in cotangents]
    return torch.autograd.grad(outs, leaves + ([vm_leaf] if view else []), g)


def _cotangents(n, dev, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, device=dev, generator=gen)
            for s in ((n, 2), (n,), (n, 3), (n,))]


def _proj_spec(args, keep, cotangents, dtype=torch.float32):
    """(means, scales, quats, viewmat) gradients of the closed form
    (ops.project._project_vjp_plain) in `dtype`, the inputs cast to it,
    for the same cotangents on the slots `keep` as `_proj_grads`."""
    means, scales, quats, vm, fx, fy, cx, cy, w, h, ts, clip, op = args
    k = keep.to(dtype)
    g = [c.to(dtype) * k.reshape((-1,) + (1,) * (c.dim() - 1))
         for c in cotangents]
    return project_kernel._project_vjp_plain(
        *(t.to(dtype) for t in (means, scales, quats, vm, fx, fy, cx, cy)),
        w, h, clip, *g)


def _grads_close(got, spec, want, truth, spec64, keep):
    """The kernel's gradients `got` bit-equal to the closed form's `spec`
    (the view matrix's within PROJ_VIEW_ATOL of its largest entry); against
    autograd's `want` at PROJ_RTOL / PROJ_ATOL, NaN where autograd's rules
    give NaN and nowhere else (sqrt's g / 0 at a compensation of exactly 0
    that the clamp passes: a needle of det_nonpositive whose a c rounds to
    b^2); no further from the float64 `truth` than twice autograd's own
    error plus 1e-9 of the largest element; and the closed form in float64
    `spec64` (None: not compared) within rtol 1e-9, atol 1e-12 of the
    largest element of `truth`, element by element."""
    for name, a, s, b, t, s64 in zip(
            ("means", "scales", "quats", "viewmat"), got, spec, want, truth,
            spec64 if spec64 is not None else (None,) * 4):
        rows = b if name == "viewmat" else b[keep]
        fin = torch.isfinite(rows)
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        assert bool(fin.any()), name
        top = float(rows[fin].abs().max())
        if name == "viewmat":
            torch.testing.assert_close(a, s, rtol=0,
                                       atol=PROJ_VIEW_ATOL * top,
                                       equal_nan=True,
                                       msg=lambda m: f"{name}: {m}")
        else:
            assert _same(a, s), (name, int((a != s).sum()))
        torch.testing.assert_close(a, b, rtol=PROJ_RTOL,
                                   atol=PROJ_ATOL * top, equal_nan=True,
                                   msg=lambda m: f"{name}: {m}")
        ok = torch.isfinite(b) & torch.isfinite(t)
        if name != "viewmat":
            ok &= keep.reshape((-1,) + (1,) * (b.dim() - 1))
        if bool(ok.any()):
            e_k = float((a.double() - t)[ok].abs().max())
            e_a = float((b.double() - t)[ok].abs().max())
            assert e_k <= 2 * e_a + 1e-9 * top, (name, e_k, e_a, top)
        if s64 is not None:
            torch.testing.assert_close(s64, t, rtol=1e-9, atol=1e-12 * top,
                                       equal_nan=True,
                                       msg=lambda m: f"{name} f64: {m}")


def _proj_checked(args, keep, cot, float64_spec=True):
    """`_grads_close` on kernel L's gradients for the cotangents `cot`."""
    _grads_close(_proj_grads(args, keep, cot), _proj_spec(args, keep, cot),
                 _proj_grads(args, keep, cot, kernel=False),
                 _proj_grads(args, keep, cot, kernel=False,
                             dtype=torch.float64),
                 _proj_spec(args, keep, cot, torch.float64)
                 if float64_spec else None, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("opacities", [True, False],
                         ids=["opacities", "q9"])
@pytest.mark.parametrize("case", proj_cases.CASES)
def test_project_kernel_forward_matches_plain(cuda, case, opacities):
    """Every output of kernel L equals the plain version's on the card bit
    for bit, on every branch (tests/project_cases.py), with the opacity-
    aware box and without (q = 9); one launch a call."""
    args = _proj_args(proj_cases.inputs(case, device=cuda), opacities)
    k = project_kernel.PROJECT_KERNEL
    before = k.launches
    got = project(*args)
    assert k.launches == before + 1
    _proj_same(got, _project_plain(*args))


def _scene_at_scale(which, dev, seed=7):
    """One camera's projection arguments over a benchmark scene's every
    slot: scene_graph_1m (2^20 + 4 x 2^15) down the corridor, or
    scene_graph_waymo3's street (2^22 + 12 x 2^15 = 4,587,520) from its
    first front image; inactive slots hold zeros."""
    import json
    from pathlib import Path

    from benchmark import scene as bscene, waymo3
    root = Path(__file__).resolve().parents[1] / "benchmark" / "configs"
    if which == "flagship":
        cfg = json.loads((root / "scene_graph_1m.json").read_text())
        st = bscene.make_scene(seed, cfg, dev)
        c2w = bscene.clip_poses(4)[3]
    else:
        cfg = json.loads((root / "scene_graph_waymo3.json").read_text())
        st = waymo3.make_scene(seed, cfg, dev)
        c2w = waymo3.c2w(cfg, 0)

    def cat(k):
        bg = st[f"bg/{k}"]
        return torch.cat([bg, st[f"obj/{k}"].reshape((-1,) + bg.shape[1:])])

    op = torch.where(cat("active"), torch.sigmoid(cat("opacities")[:, 0]),
                     torch.zeros((), device=dev))
    cam = Camera.make(1200.0, 1200.0, 800.0, 528.0, c2w, 1600, 1056,
                      device=dev)
    return (cat("means"), torch.exp(cat("scales")), cat("quats"),
            viewmat_from_c2w(cam.c2w), cam.fx, cam.fy, cam.cx, cam.cy,
            1600, 1056, 16, 0.01, op)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["flagship", "waymo3"])
def test_project_kernel_at_scale(cuda, which):
    """A whole benchmark scene: the forward bit-equal to the plain
    version's, the backward (every cotangent on every slot) bit-equal to
    the closed form's and within the stated tolerances of autograd's, in
    one device launch each way."""
    args = _scene_at_scale(which, cuda)
    n = args[0].shape[0]
    _proj_same(project(*args), _project_plain(*args))
    keep = torch.ones(n, dtype=torch.bool, device=cuda)
    cot = _cotangents(n, cuda)
    _proj_checked(args, keep, cot)
    k = project_kernel.PROJECT_KERNEL
    assert _cuda.captured_launches(k, lambda: project(*args)) == 1
    assert _cuda.captured_launches(k, lambda: project_kernel.project_bwd(
        *args[:10], 0.01, *cot)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", proj_cases.CASES)
def test_project_kernel_backward_matches_autograd(cuda, case):
    """Kernel L's backward against its closed form and autograd through
    the plain version on the card, the view matrix and the compensation
    included, at the stated tolerances; the slots
    tests/project_cases.compared names."""
    args = _proj_args(proj_cases.inputs(case, device=cuda))
    keep = proj_cases.compared(case, _project_plain(*args))
    cot = _cotangents(args[0].shape[0], cuda)
    # det_nonpositive's needles have det <= 0 only in float32 (the blur is
    # lost to the rounding of a' c'); cast to float64 their det is positive
    # and ill-conditioned, so the closed form is held to autograd in
    # float64 there on needles made in float64, by the CPU tests.
    _proj_checked(args, keep, cot,
                  float64_spec=case != "det_nonpositive")


@pytest.mark.cuda
def test_project_kernel_camera_opt_gradient(cuda):
    """camera_opt_mode="SO3xR3": the pose tangent's gradient through the
    view matrix (kernel L's two-pass sum over the blocks) against
    autograd through the plain version, and the same bits twice."""
    from benchmark import scene as bscene
    from street_gaussians_ns_tpu_torch.models.camera_opt import (
        CameraOptConfig, apply_camera_opt)
    args = _scene_at_scale("flagship", cuda)
    means, scales, quats, _, fx, fy, cx, cy, w, h, ts, clip, op = args
    c2w = torch.tensor(np.asarray(bscene.clip_poses(4)[3]), device=cuda)
    conf = CameraOptConfig(mode="SO3xR3", num_cameras=2)
    n = means.shape[0]
    cot = _cotangents(n, cuda)
    got = []
    for proj_fn in (project, project, _project_plain):
        tangent = torch.full((2, 6), 1e-3, device=cuda, requires_grad=True)
        vm = viewmat_from_c2w(apply_camera_opt(conf, tangent, 1, c2w))
        p = proj_fn(means, scales, quats, vm, fx, fy, cx, cy, w, h, ts, clip,
                    op)
        got.append(torch.autograd.grad([p.xys, p.depths, p.conics, p.comp],
                                       tangent, cot)[0])
    assert _bits(got[0], got[1])
    torch.testing.assert_close(got[0], got[2], rtol=1e-3,
                               atol=1e-4 * float(got[2].abs().max()))


@pytest.mark.cuda
def test_project_kernel_launches_and_host_syncs(cuda):
    """One launch forward and one backward by the counter (mode "bwd"),
    one device launch each way (two backward when the view matrix is
    differentiated: the blocks' partials, then their sum), and no host
    synchronisation on the way (torch.cuda.set_sync_debug_mode)."""
    args = _proj_args(proj_cases.inputs("in_view", n=3000, device=cuda))
    means, scales, quats, vm, *rest = args
    leaves = [t.clone().requires_grad_(True) for t in (means, scales, quats,
                                                       vm)]
    k = project_kernel.PROJECT_KERNEL
    before, before_bwd = k.launches, k.mode_launches.get("bwd", 0)
    cot = _cotangents(means.shape[0], cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p = project(*leaves, *rest)
        grads = torch.autograd.grad([p.xys, p.depths, p.conics], leaves,
                                    cot[:3])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert k.launches == before + 2
    assert k.mode_launches.get("bwd", 0) == before_bwd + 1
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert _cuda.captured_launches(k, lambda: project_kernel.project_bwd(
        *args[:10], 0.01, *cot)) == 1
    assert _cuda.captured_launches(k, lambda: project_kernel.project_bwd(
        *args[:10], 0.01, *cot, view_grad=True)) == 2


@pytest.mark.cuda
def test_project_kernel_repeats_bit_for_bit(cuda):
    """Two runs of the forward and of the backward, the view matrix's sum
    over 4.6 M slots included, give the same bits."""
    args = _scene_at_scale("waymo3", cuda)
    n = args[0].shape[0]
    keep = torch.ones(n, dtype=torch.bool, device=cuda)
    cot = _cotangents(n, cuda)
    a, b = project(*args), project(*args)
    for f in PROJ_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), f
    ga, gb = _proj_grads(args, keep, cot), _proj_grads(args, keep, cot)
    assert all(_bits(x, y) for x, y in zip(ga, gb))


@pytest.mark.cuda
@pytest.mark.parametrize("rows_from,cols", [(1, 8), (3, 11)])
def test_project_kernel_on_views(cuda, rows_from, cols):
    """Row views of wider tables (as compose's flat set is sliced) and
    strided cotangents (the depth's is a column of the colours' gradient)
    give the same bits as contiguous copies, with the mask and the offset
    folded in as ops.render applies them."""
    means, scales, quats, opac, vm, fx, fy, cx, cy = proj_cases.inputs(
        "in_view", n=2000, device=cuda)
    n = means.shape[0]
    active = torch.arange(n, device=cuda) % 5 != 0
    off = torch.randn((n, 2), device=cuda)
    colors = torch.randn((n, 4), device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(3))

    def wide(t):
        tab = torch.zeros((rows_from + n, cols), device=cuda)
        tab[rows_from:, :t.shape[1]] = t
        tab.requires_grad_(True)
        return tab, tab[rows_from:, :t.shape[1]]

    def dense(t):
        leaf = t.clone().requires_grad_(True)
        return leaf, leaf

    def run(make):
        leaves, used = zip(*(make(t) for t in (means, scales, quats)))
        p = project(*used, vm, fx, fy, cx, cy, proj_cases.WIDTH,
                    proj_cases.HEIGHT, opacities=opac, active=active,
                    xys_offset=off)
        g = torch.autograd.grad(
            [p.xys, torch.cat([p.conics, p.depths[:, None]], 1)], leaves,
            [torch.ones_like(p.xys), colors])
        return p, [gi[-n:, :t.shape[1]] for gi, t in zip(g, used)]

    p_view, g_view = run(wide)
    p_dense, g_dense = run(dense)
    _proj_same(p_view, p_dense)
    plain = _project_plain(means, scales, quats, vm, fx, fy, cx, cy,
                           proj_cases.WIDTH, proj_cases.HEIGHT, opacities=opac)
    assert _same(p_dense.xys, plain.xys + off)
    assert _same(p_dense.radii, torch.where(active, plain.radii, 0))
    assert _same(p_dense.num_tiles_hit,
                 torch.where(active, plain.num_tiles_hit, 0))
    assert all(_bits(a, b) for a, b in zip(g_view, g_dense))


@pytest.mark.cuda
def test_project_kernel_in_the_train_step(cuda):
    """The main path: a scene-graph train step projects once through
    kernel L and differentiates it once (span render.project_bwd, on
    autograd's thread), with nothing of the plain version's graph."""
    import test_torch_tracing as tt
    from street_gaussians_ns_tpu_torch.utils import profiling
    scene, batch = tt._scene("cuda"), tt._batch("cuda")
    k = project_kernel.PROJECT_KERNEL
    profiling.reset()
    profiling.enable(True)
    try:
        before, before_bwd = k.launches, k.mode_launches.get("bwd", 0)
        tt._scene_step(scene, batch)
        snap = profiling.snapshot()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert k.launches == before + 2
    assert k.mode_launches.get("bwd", 0) == before_bwd + 1
    assert snap["render.project_bwd"]["count"] == 1
    assert snap["render.project_bwd"]["device_ms"] > 0
