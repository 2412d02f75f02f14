"""precision="bf16" in the port (ops/packing.py, the bf16 branch of
ops/tiles._depth_sort_cols, the fused routes of ops/composite.py, the
render through them; the train step and the sliced route in
tests/test_torch_bf16_train.py) against the JAX package's bf16 route on
the CPU (its Pallas kernels in interpret mode), at small sizes.

Both sides round the same columns to bf16 explicitly (conics, opacity,
colours and the depth copy; xy and the depth key stay float32), so the
tolerances are the f32 route's: packed words, sorted columns and pair
enumeration bit for bit; rendered heads at atol 2e-5 and depth at rtol
1e-4 where the accumulation is > 1e-3; the training step as
tests/test_torch_train_step.py holds it; the sliced route as
tests/test_torch_slices.py holds it against the JAX sliced route."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.models import scene_graph as jsg
from street_gaussians_ns_tpu.ops import packing as jpacking
from street_gaussians_ns_tpu.ops import render as jrender
from street_gaussians_ns_tpu.ops import tiles as jtiles
from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
from street_gaussians_ns_tpu_torch.models import scene_graph as tsg
from street_gaussians_ns_tpu_torch.ops import packing
from street_gaussians_ns_tpu_torch.ops import render as trender
from street_gaussians_ns_tpu_torch.ops import tiles as ttiles

from test_rasterize import make_scene as rgb_scene
from test_torch_binning import _assert_same, _inputs
from test_torch_render import _cameras, assert_heads_close
from test_torch_scene_graph import (DEPTH_OF, MAX_PAIRS, port_config,
                                    store_arrays)
from test_torch_scene_graph import scene as eval_scene  # noqa: F401


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


def _special_values() -> np.ndarray:
    """NaNs (both signs, payloads), infinities, signed zeros, subnormals,
    halfway cases and a spread of magnitudes."""
    bits = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
                     0x7FC12345, 0x7F800000, 0xFF800000, 0x80000000, 0,
                     0x00000001, 0x80000001, 0x007FFFFF, 0x00008000,
                     0x00018000, 0x3F808000, 0x3F818000, 0x3F808001,
                     0x7F7FFFFF, 0xFF7FFFFF], np.uint32)
    rng = np.random.default_rng(0)
    spread = (rng.standard_normal(2000) * 10.0 ** rng.integers(
        -44, 38, 2000)).astype(np.float32)
    return np.concatenate([bits.view(np.float32), spread])


def test_pack2_unpack2_match_jax_bit_for_bit():
    v = _special_values()
    a, b = v, np.roll(v, 7)
    want = np.asarray(jax.jit(jpacking.pack2)(a, b))
    got = packing.pack2(T(a), T(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ja, jb = jax.jit(jpacking.unpack2)(want)
    ta, tb = packing.unpack2(T(want))
    for t, j in ((ta, ja), (tb, jb)):
        np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                      np.asarray(j).view(np.uint32))
    rounded = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(
        jnp.float32))
    np.testing.assert_array_equal(packing.round_bf16(T(v)).numpy().view(
        np.uint32), rounded.view(np.uint32))


@pytest.mark.parametrize("seed,n,w,h,n_hidden,lcd", [
    (0, 150, 48, 32, 0, False),
    (1, 150, 48, 32, 30, True),
    (2, 200, 50, 37, 0, True)])
def test_bf16_binning_matches_jax_bit_for_bit(seed, n, w, h, n_hidden, lcd):
    """_depth_sort_cols' rounded columns and bin_and_pack's bins and 11
    sorted-pair columns (the JAX package's unpacked payloads)."""
    p, dk, colors, opac = _inputs(seed, n, w, h, n_hidden, lcd)
    ntx, nty = -(-w // 16), -(-h // 16)
    jcols, _, _ = jtiles._depth_sort_cols(
        p.xys, p.conics, p.tile_box, dk, colors, opac, ntx, nty, lcd, "bf16")
    dk_s, order, fs, box_s = ttiles._depth_sort_cols(
        T(p.xys), T(p.conics), T(p.tile_box), T(dk), T(colors), T(opac), lcd,
        precision="bf16")
    np.testing.assert_array_equal(dk_s.numpy(), np.asarray(jcols[0]))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jcols[1]))
    for i, j in enumerate((2, 3, 4, 5, 6, 7, 12, 13, 14, 15)):
        np.testing.assert_array_equal(fs[:, i].numpy(), np.asarray(jcols[j]),
                                      err_msg=f"column {j}")
    np.testing.assert_array_equal(box_s.numpy(), np.stack(
        [np.asarray(c) for c in jcols[8:12]], -1))
    f32 = ttiles._depth_sort_cols(
        T(p.xys), T(p.conics), T(p.tile_box), T(dk), T(colors), T(opac),
        lcd)[2]
    assert bool((f32[:, :2] == fs[:, :2]).all())       # xy not rounded
    assert bool((f32[:, 2:5] != fs[:, 2:5]).any())     # conics rounded

    jb, jf = jax.jit(jtiles.bin_and_pack, static_argnames=(
        "width", "height", "tile_size", "max_pairs", "with_gauss_idx",
        "last_color_is_depth", "precision"))(
        p.xys, p.conics, p.tile_box, dk, colors, opac, width=w, height=h,
        tile_size=16, max_pairs=8192, with_gauss_idx=False,
        last_color_is_depth=lcd, precision="bf16")
    tb, tf = ttiles.bin_and_pack(
        T(p.xys), T(p.conics), T(p.tile_box), T(dk), T(colors), T(opac), w,
        h, 16, 8192, last_color_is_depth=lcd, precision="bf16")
    assert 0 < int(tb.num_pairs) <= 8192
    _assert_same(jb, jf, tb, tf)


def test_bf16_render_matches_jax():
    """ops.render.render at precision="bf16" against the JAX bf16 render
    (Pallas in interpret mode); the bf16 frame differs from the f32 one."""
    means, scales, quats, colors, opac, _ = rgb_scene(300, 4, w=64, h=48)
    args = [np.asarray(a) for a in (means, scales, quats, opac, colors)]
    jcam, tcam = _cameras(64, 48)
    sky = np.random.default_rng(4).random((48, 64, 3), dtype=np.float32)
    jcfg = jrender.RenderConfig(max_pairs=8192, impl="pallas",
                                interpret=True, precision="bf16")
    jout = jax.jit(jrender.render, static_argnames=("config", "training"))(
        *args, jcam, config=jcfg, sky_rgb=sky, training=False)
    heads = ("rgb", "accumulation", "depth")
    outs = {}
    for prec in ("bf16", "f32"):
        outs[prec] = trender.render(
            *map(T, args), tcam,
            trender.RenderConfig(max_pairs=8192, precision=prec),
            sky_rgb=T(sky), training=False)
    assert_heads_close({k: getattr(outs["bf16"], k) for k in heads},
                       {k: getattr(jout, k) for k in heads},
                       {"depth": "accumulation"})
    assert int(outs["bf16"].bins.num_pairs) == int(jout.bins.num_pairs)
    diff = (outs["bf16"].rgb - outs["f32"].rgb).abs().max()
    assert 0 < float(diff) < 1e-2


def test_bf16_forward_scene_matches_jax(eval_scene):  # noqa: F811
    """The scene graph's eval render (every head) at precision="bf16"."""
    jcfg, jstore, jtracks = eval_scene
    jc, tc = _cameras(64, 48, time=1.0)
    jr = jrender.RenderConfig(max_pairs=MAX_PAIRS, impl="pallas",
                              interpret=True, precision="bf16")
    jout, _, _ = jax.jit(jsg.forward_scene, static_argnames=(
        "config", "render_config", "training", "eval_extras"))(
        jstore, jtracks, jc, jnp.int32(0), config=jcfg, render_config=jr,
        training=False, eval_extras=True)
    store = tckpt.store_from_numpy(store_arrays(jstore), port_config(jcfg),
                                   device="cpu")
    tracks = tckpt.tracks_from_numpy(store_arrays(jtracks), device="cpu")
    tout, _, _ = tsg.forward_scene(
        store, tracks, tc, 0, port_config(jcfg),
        trender.RenderConfig(max_pairs=MAX_PAIRS, precision="bf16"),
        training=False, eval_extras=True)
    assert set(tout) == set(jout)
    assert_heads_close(tout, jout, DEPTH_OF)
