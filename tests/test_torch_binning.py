"""The port's fused binning (ops/tiles.bin_and_pack, count_pairs) against
the JAX package's on the same projected inputs, on the CPU.

Pair enumeration and order are integers and must match bit for bit: every
int field of TileBins, and the 11 sorted-pair feature columns (pure data
movement of the same float32 values) exactly. The JAX side runs its CPU
fallbacks (jnp.cumsum, the searchsorted expansion)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.ops import tiles as jtiles
from street_gaussians_ns_tpu_torch.core.projection import Projected, coverage_q
from street_gaussians_ns_tpu_torch.ops import tiles as ttiles

from test_fused_binning import _project
from test_pallas_composite import make_scene
from trim_cases import table as trim_table


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STATIC = ("width", "height", "tile_size", "max_pairs", "max_rowruns",
          "with_gauss_idx", "last_color_is_depth")
INT_FIELDS = ("tile_start", "tile_count", "pair_valid", "num_pairs",
              "num_rowruns", "depth_order", "exp_starts", "exp_counts")


def T(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed, n, w, h, n_hidden, last_color_is_depth):
    means, scales, quats, colors, opac, cam = make_scene(n, seed, w=w, h=h)
    if n_hidden:
        # Behind the camera: invisible, +inf depth keys.
        means = means.at[:n_hidden, 2].set(5.0)
    p = _project(means, scales, quats, cam)
    if last_color_is_depth:
        colors = colors.at[:, -1].set(p.depths)
    depth_key = jnp.where(p.num_tiles_hit > 0, p.depths, jnp.inf)
    return p, depth_key, colors, opac


def _both(p, depth_key, colors, opac, w, h, max_pairs, max_rowruns=None,
          last_color_is_depth=False):
    jb, jf = jax.jit(jtiles.bin_and_pack, static_argnames=STATIC)(
        p.xys, p.conics, p.tile_box, depth_key, colors, opac, width=w,
        height=h, tile_size=16, max_pairs=max_pairs, max_rowruns=max_rowruns,
        with_gauss_idx=False, last_color_is_depth=last_color_is_depth)
    tb, tf = ttiles.bin_and_pack(
        T(p.xys), T(p.conics), T(p.tile_box), T(depth_key), T(colors),
        T(opac), w, h, 16, max_pairs, max_rowruns,
        last_color_is_depth=last_color_is_depth)
    return jb, jf, tb, tf


def _assert_same(jb, jf, tb, tf):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert (tb.num_tiles_x, tb.num_tiles_y) == (jb.num_tiles_x,
                                                jb.num_tiles_y)
    assert len(tf) == len(jf) == 11
    for i, (a, b) in enumerate(zip(tf, jf)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"feature column {i}")


@pytest.mark.parametrize("seed,n,w,h,n_hidden,lcd", [
    (0, 150, 48, 32, 0, False),
    (1, 150, 48, 32, 30, True),
    (2, 200, 50, 37, 0, True),
    (3, 200, 50, 37, 40, False)])
def test_bin_and_pack_matches_jax(seed, n, w, h, n_hidden, lcd):
    p, dk, colors, opac = _inputs(seed, n, w, h, n_hidden, lcd)
    jb, jf, tb, tf = _both(p, dk, colors, opac, w, h, 8192,
                           last_color_is_depth=lcd)
    assert 0 < int(tb.num_pairs) <= 8192
    _assert_same(jb, jf, tb, tf)
    assert int(tb.max_tile_count) == int(jb.max_tile_count)


def test_overflow_reports_true_totals():
    p, dk, colors, opac = _inputs(4, 300, 48, 32, 0, False)
    tb_full, _ = ttiles.bin_and_pack(
        T(p.xys), T(p.conics), T(p.tile_box), T(dk), T(colors), T(opac),
        48, 32, 16, 16384)
    true_pairs = int(tb_full.num_pairs)
    true_runs = int(tb_full.num_rowruns)
    max_pairs = 256     # and max_rowruns 128: both capacities overflow
    assert true_pairs > max_pairs and true_runs > max_pairs // 2
    jb, jf, tb, tf = _both(p, dk, colors, opac, 48, 32, max_pairs)
    assert int(tb.num_pairs) == true_pairs
    assert int(tb.num_rowruns) == true_runs
    assert 0 < int(tb.tile_count.sum()) <= max_pairs
    _assert_same(jb, jf, tb, tf)


def test_count_pairs_matches_jax():
    p, _, _, opac = _inputs(5, 200, 50, 37, 20, False)
    tp = Projected(**{k: T(getattr(p, k)) for k in (
        "xys", "depths", "radii", "conics", "comp", "num_tiles_hit",
        "tile_box")})
    for op in (None, opac):
        want = jtiles.count_pairs(p, 50, 37, 16, opacities=op)
        got = ttiles.count_pairs(tp, 50, 37, 16,
                                 opacities=None if op is None else T(op))
        assert [int(v) for v in got] == [int(v) for v in want]


@pytest.mark.parametrize("n,width,height,trim_elems", [
    (0, 1600, 1056, None),
    (1, 1600, 1056, None),
    (255, 1600, 1056, None),
    (257, 480, 270, None),
    (3000, 1600, 1056, None),             # max_h 66
    (3000, 480, 270, None),               # max_h 17
    (3000, 480, 270, 1000),               # chunks of 58 gaussians
    ((1 << 23) // 66 + 257, 1600, 1056, None),   # past the first chunk
])
def test_row_trim_matches_jax(monkeypatch, n, width, height, trim_elems):
    """The plain trim, kernel I's specification, against the JAX package's
    on trim_cases' rows: (first, last, count) exact."""
    if trim_elems is not None:
        monkeypatch.setattr(ttiles, "_TRIM_ELEMS", trim_elems)
    max_h = -(-height // 16)
    tab, box = trim_table(np.random.default_rng(n + width), n, width, height)
    q = coverage_q(T(tab[:, 5]))
    got = ttiles._row_trim_counts(T(tab)[:, 2:5], T(tab)[:, 0:2], T(box), 16,
                                  max_h, q)
    want = jtiles._row_trim_counts(jnp.asarray(tab[:, 2:5]),
                                   jnp.asarray(tab[:, 0:2]),
                                   jnp.asarray(box), 16, max_h,
                                   jnp.asarray(q.numpy()))
    for name, g, w in zip(("first", "last", "count"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if n >= 3000:
        assert int(got[2].sum()) > n and int((got[0] > 0).sum()) > 0
