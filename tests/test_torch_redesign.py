"""What the CPU can reach of the redesigned kernels A (flat scan) and E
(backward compositor) of the port.

The CUDA sources run on the card only (tests/test_torch_cuda.py). Here:

- a numpy model of kernel A's single-pass scan with decoupled look-back
  (`csrc/scan.cu`): tiles taken by ticket, 64-bit descriptors in the three
  states EMPTY / AGGREGATE / INCLUSIVE, a look-back 32 descriptors at a
  time, the last block zeroing the scratch; run under a seeded random
  interleaving of the blocks it must equal `np.cumsum` /
  `np.maximum.accumulate` exactly for int32 add, int32 max and float32
  max. The float32 add runs the ordered variant (no INCLUSIVE past tile 0,
  every predecessor's AGGREGATE combined in one fixed order): two
  different interleavings give the same bits, and the result is within
  rtol 1e-5 of the largest running sum of a float64 sum;
- the wrapper's scratch sizing and its per-stream scratch;
- the pairs a tile's backward visits (`visited_counts`);
- `composite_bwd` on the CPU zero-filled by default, and the fused
  route's contract that rows past a tile's visited pairs are undefined:
  the rank-keyed reduce gives the same gradients with NaN there;
- the line replacements of `bwd_ablation.py` on kernel E's source;
- `bins_from_numpy` lands on the card unless asked for the CPU.
"""
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu_torch.core.cameras import Camera, viewmat_from_c2w
from street_gaussians_ns_tpu_torch.core.projection import project
from street_gaussians_ns_tpu_torch.ops import composite, scan, tiles


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Kernel A: the look-back protocol.
# ---------------------------------------------------------------------------

TILE = scan.TILE
EMPTY, AGGREGATE, INCLUSIVE = 0, 1, 2
WINDOW = 32

OPS = {
    ("int32", "add"): (np.int32, np.add, np.int32(0)),
    ("int32", "max"): (np.int32, np.maximum, np.iinfo(np.int32).min),
    ("float32", "max"): (np.float32, np.maximum, np.float32(-np.inf)),
    ("float32", "add"): (np.float32, np.add, np.float32(0)),
}


def _block(x, out, scratch, num_tiles, op, ident, ordered):
    """One block of csrc/scan.cu as a generator: it yields wherever the
    card could run another block first. scratch = {"ticket", "done",
    "desc": [(status, value)]}."""
    tile = scratch["ticket"]
    scratch["ticket"] += 1
    yield
    lo = tile * TILE
    local = op.accumulate(x[lo:lo + TILE], dtype=x.dtype)
    agg = local[-1]
    desc = scratch["desc"]
    prefix = ident
    if tile == 0:
        desc[0] = (INCLUSIVE, agg)
    else:
        desc[tile] = (AGGREGATE, agg)
        yield
        b = tile - 1
        while True:
            idx = [b - lane for lane in range(WINDOW)]
            # Spin until no descriptor of the window is EMPTY.
            while any(i >= 0 and desc[i][0] == EMPTY for i in idx):
                yield
            seen = [desc[i] if i >= 0 else (INCLUSIVE, ident) for i in idx]
            incl = [lane for lane, d in enumerate(seen) if d[0] == INCLUSIVE]
            last = incl[0] if incl else WINDOW - 1
            vals = [d[1] if lane <= last else ident
                    for lane, d in enumerate(seen)]
            # The shuffle tree: lane l takes lane l + off, off = 16 .. 1.
            off = WINDOW // 2
            while off:
                vals = [op(vals[lane], vals[lane + off])
                        if lane + off < WINDOW else vals[lane]
                        for lane in range(WINDOW)]
                off //= 2
            prefix = op(vals[0], prefix)
            if incl:
                break
            b -= WINDOW
            yield
        if not ordered:
            desc[tile] = (INCLUSIVE, op(prefix, agg))
    scratch["done"] += 1
    last_block = scratch["done"] == num_tiles
    yield
    out[lo:lo + TILE] = op(prefix, local)
    if last_block:
        scratch["desc"][:num_tiles] = [(EMPTY, ident)] * num_tiles
        scratch["ticket"] = scratch["done"] = 0


def lookback_scan_model(x, op, ident, ordered, seed, resident=7,
                        scratch=None):
    """The scan under a seeded random interleaving of at most `resident`
    blocks at a time (a block starts only when the card has room, and
    takes its tile by ticket when it starts)."""
    n = x.shape[0]
    num_tiles = -(-n // TILE)
    out = np.empty_like(x)
    if num_tiles <= 1:
        return op.accumulate(x, dtype=x.dtype), scratch
    if scratch is None:
        scratch = {"ticket": 0, "done": 0,
                   "desc": [(EMPTY, ident)] * scan._scratch_len(n)}
    assert scratch["ticket"] == 0 and scratch["done"] == 0
    assert all(d[0] == EMPTY for d in scratch["desc"])
    rng = np.random.default_rng(seed)
    waiting = num_tiles
    running = []
    while waiting or running:
        if waiting and (len(running) < resident and
                        (not running or rng.random() < 0.5)):
            g = _block(x, out, scratch, num_tiles, op, ident, ordered)
            next(g)                          # the block takes its ticket
            running.append(g)
            waiting -= 1
            continue
        i = int(rng.integers(len(running)))
        try:
            next(running[i])
        except StopIteration:
            running.pop(i)
    return out, scratch


SIZES = [1, TILE - 1, TILE, TILE + 1, 33 * TILE + 7, 70_001]


def _input(n, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-5, 9, n).astype(np.int32)
    return rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype,opname", [("int32", "add"), ("int32", "max"),
                                          ("float32", "max")])
def test_lookback_model_is_exact(n, dtype, opname):
    np_dtype, op, ident = OPS[(dtype, opname)]
    x = _input(n, dtype, n)
    got, scratch = lookback_scan_model(x, op, ident, False, seed=n)
    np.testing.assert_array_equal(got, op.accumulate(x, dtype=np_dtype))
    # It equals the port's wrapper (the plain version on the CPU) too.
    fn = scan.cumsum_flat if opname == "add" else scan.cummax_flat
    np.testing.assert_array_equal(got, fn(torch.from_numpy(x)).numpy())
    if scratch is not None:
        # The last block left the scratch zeroed: a second launch on it,
        # under another interleaving, is right as well.
        again, _ = lookback_scan_model(x, op, ident, False, seed=n + 1,
                                       resident=3, scratch=scratch)
        np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("n", SIZES)
def test_lookback_model_float_add_is_ordered(n):
    np_dtype, op, ident = OPS[("float32", "add")]
    x = _input(n, "float32", n)
    a, _ = lookback_scan_model(x, op, ident, True, seed=1)
    b, _ = lookback_scan_model(x, op, ident, True, seed=2, resident=2)
    np.testing.assert_array_equal(a, b)
    want = np.cumsum(x.astype(np.float64))
    assert np.abs(a - want).max() <= 1e-5 * np.abs(want).max() + 1e-6


def test_lookback_model_unordered_float_add_would_not_repeat():
    """Why the float32 add needs the ordered variant: with INCLUSIVE
    descriptors in play, which predecessors a tile finds summarised
    depends on the interleaving, and so does the rounding."""
    _, op, ident = OPS[("float32", "add")]
    x = (_input(40 * TILE, "float32", 3) * 1e3).astype(np.float32)
    outs = {lookback_scan_model(x, op, ident, False, seed=s,
                                resident=r)[0].tobytes()
            for s, r in ((1, 2), (2, 7), (3, 16), (4, 31))}
    assert len(outs) > 1


# ---------------------------------------------------------------------------
# Kernel A: the wrapper's scratch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,words", [
    (1, 0), (TILE, 0), (TILE + 1, 3), (2 * TILE, 3), (33 * TILE + 7, 35),
    (2_097_152, 513), ((1 << 24) + 3, 4098)])
def test_scan_scratch_len(n, words):
    assert scan._scratch_len(n) == words


def test_scan_scratch_is_per_stream_zeroed_and_grows(monkeypatch):
    monkeypatch.setattr(scan, "_scratch", {})
    cpu = torch.device("cpu")
    a = scan._scratch_for(cpu, 11, 513)
    assert a.dtype == torch.int64 and a.numel() >= scan._MIN_SCRATCH
    assert not a.any()
    assert scan._scratch_for(cpu, 11, 35) is a        # kept for the stream
    b = scan._scratch_for(cpu, 12, 513)
    assert b is not a and b.data_ptr() != a.data_ptr()  # never shared
    big = scan._scratch_for(cpu, 11, 3 * scan._MIN_SCRATCH)
    assert big is not a and big.numel() >= 3 * scan._MIN_SCRATCH
    assert big.numel() & (big.numel() - 1) == 0 and not big.any()
    assert scan._scratch_for(cpu, 11, 513) is big
    assert len(scan._scratch) == 2


# ---------------------------------------------------------------------------
# Kernel E: the visited pairs and the undefined rows.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_visited_counts_are_the_largest_n_contrib_within_the_tile(seed):
    rng = np.random.default_rng(seed)
    tc = rng.integers(0, 6, size=300).astype(np.int32) * 40
    tc[rng.random(300) < 0.3] = 0
    deepest = rng.integers(0, 300, size=(300, 1))
    ncon = (rng.random((300, 256)) * deepest).astype(np.int32)
    nvis = composite.visited_counts(torch.from_numpy(ncon),
                                    torch.from_numpy(tc))
    assert nvis.dtype == torch.int32 and tuple(nvis.shape) == (300,)
    nvis = nvis.numpy()
    np.testing.assert_array_equal(nvis, np.minimum(ncon.max(axis=1), tc))
    assert (nvis == 0).any() and (nvis == tc)[tc > 0].any()
    assert (nvis < tc).any()


def _scene(seed, n=900, w=112, h=80, nc=4):
    """A projected random scene binned, packed and composited on the CPU,
    with cotangents: the arguments of composite_bwd and the bins."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.standard_normal((n, 2)),
                            -rng.random((n, 1)) * 8.0 - 2.0], 1)
    q = rng.standard_normal((n, 4))
    args = [torch.tensor(a, dtype=torch.float32) for a in (
        means, np.exp(rng.standard_normal((n, 3)) * 0.5 - 2.5),
        q / np.linalg.norm(q, axis=1, keepdims=True))]
    op = torch.tensor(rng.random(n) * 0.9 + 0.05, dtype=torch.float32)
    colors = torch.tensor(rng.random((n, nc)), dtype=torch.float32)
    cam = Camera.make(100.0, 100.0, w / 2, h / 2, np.eye(3, 4), w, h,
                      device="cpu")
    p = project(*args, viewmat_from_c2w(cam.c2w), cam.fx, cam.fy, cam.cx,
                cam.cy, w, h, opacities=op)
    depth_key = torch.where(p.num_tiles_hit > 0, p.depths,
                            torch.full_like(p.depths, float("inf")))
    max_pairs = 1 << 13
    bins, feats = tiles.bin_and_pack(p.xys, p.conics, p.tile_box, depth_key,
                                     colors, op, w, h, 16, max_pairs)
    assert 0 < int(bins.num_pairs) <= max_pairs
    feat = composite.pack_feat_cols(feats, max_pairs)
    ntx = bins.num_tiles_x
    accum, tfin, ncon = composite.composite_fwd(
        feat, bins.tile_start, bins.tile_count, ntx, nc)
    g_accum = torch.tensor(rng.standard_normal(tuple(accum.shape)),
                           dtype=torch.float32)
    g_t = torch.tensor(rng.standard_normal(tuple(tfin.shape)),
                       dtype=torch.float32)
    return (feat, bins.tile_start, bins.tile_count, ntx, nc, g_accum, g_t,
            tfin, ncon, accum), bins


def test_composite_bwd_defines_every_row_by_default():
    """The public default stays zero-filled: the plain version's tensor,
    zeros wherever no pixel of the tile reached the pair."""
    args, _ = _scene(0)
    got = composite.composite_bwd(*args)
    want = composite.composite_bwd_plain(
        *args[:-1], torch.sum(args[5] * args[9], dim=-1))
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    nvis = composite.visited_counts(args[8], args[2])
    visited = torch.zeros(got.shape[0] * composite.K, dtype=torch.bool)
    visited[composite._visited_pairs(args[1], nvis)] = True
    per_pair = got.permute(0, 2, 1).reshape(-1, composite.NFEAT)
    assert not per_pair[~visited].any() and bool(per_pair[visited].any())


@pytest.mark.parametrize("seed,nc", [(0, 4), (1, 3)])
def test_reduce_reads_only_the_visited_pairs(seed, nc):
    """zero_fill=False leaves every pair past a tile's visited ones
    undefined (NaN on the CPU); the fused route's reduce must not see
    them."""
    args, bins = _scene(seed, nc=nc)
    ts, tc, ncon = args[1], args[2], args[8]
    nvis = composite.visited_counts(ncon, tc)
    assert int(nvis.sum()) < int(tc.sum())           # some pairs unvisited
    filled = composite.composite_bwd(*args)
    loose = composite.composite_bwd(*args, zero_fill=False)
    assert bool(torch.isnan(loose).any())
    pair = composite._visited_pairs(ts, nvis)
    rows, lanes = pair // composite.K, pair % composite.K
    assert torch.equal(loose[rows, :11, lanes], filled[rows, :11, lanes])
    unvisited = torch.ones(filled.shape[0] * composite.K, dtype=torch.bool)
    unvisited[pair] = False
    per_pair = loose.permute(0, 2, 1).reshape(-1, composite.NFEAT)
    assert bool(torch.isnan(per_pair[unvisited]).all())
    assert bool(torch.isnan(per_pair[:, 11:]).all())   # never written
    n = bins.depth_order.shape[0]
    want = composite._reduce_pair_grads_ranked(filled, ts, nvis,
                                               bins.depth_order, n)
    got = composite._reduce_pair_grads_ranked(loose, ts, nvis,
                                              bins.depth_order, n)
    assert bool(torch.isfinite(got).all()) and bool(want.any())
    assert torch.equal(got, want)
    # The whole backward from tile cotangents takes the undefined route.
    seg = composite._bwd_from_tiles(args[0], ts, tc, args[3], args[9],
                                    args[7], ncon, args[5], args[6],
                                    bins.depth_order, n)
    assert torch.equal(seg, want)


# ---------------------------------------------------------------------------
# The ablation script's scratch copies of kernel E still find their lines.
# ---------------------------------------------------------------------------

def test_ablation_patches_apply_to_the_shipped_kernel():
    """bwd_ablation.py times copies of csrc/composite_bwd.cu with a few
    lines replaced; an edit of the kernel that moves those lines must
    show here, not on the card."""
    import bwd_ablation as ab
    shipped = ab.SHIPPED.read_text()
    seen = set()
    for name, (first_version, switches, _) in ab.VARIANTS.items():
        if first_version:
            continue
        text = ab.patched(ab.SHIPPED, switches)
        assert "abl_set" in text and text != shipped
        assert ("abl_order[blockIdx.x]" in text) == ("order" in switches)
        seen.add(text)
    assert len(seen) == sum(not v[0] for v in ab.VARIANTS.values())
    with pytest.raises(ValueError):
        ab.replace_once(shipped, "no such line", "", "test")


# ---------------------------------------------------------------------------
# bins_from_numpy lands on the card unless asked otherwise.
# ---------------------------------------------------------------------------

def _bins_arrays():
    _, bins = _scene(2, n=200, w=48, h=32)
    out = {name: getattr(bins, name) for name in tiles._TENSOR_FIELDS}
    out["pair_valid"] = torch.ones(4, dtype=torch.bool)
    out = {k: v.numpy() for k, v in out.items()}
    out.update(num_tiles_x=bins.num_tiles_x, num_tiles_y=bins.num_tiles_y)
    return out


def test_bins_from_numpy_defaults_to_the_card():
    arrays = _bins_arrays()
    on_cpu = tiles.bins_from_numpy(arrays, device="cpu")
    assert on_cpu.tile_count.device.type == "cpu"
    assert on_cpu.num_pairs.dtype == torch.int64
    if torch.cuda.is_available():
        assert tiles.bins_from_numpy(arrays).tile_count.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tiles.bins_from_numpy(arrays)
