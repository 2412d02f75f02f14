"""What the CPU can reach of the redesigned kernels D (forward compositor)
and F (rank-keyed row sum) of the port.

The CUDA sources run on the card only (tests/test_torch_cuda.py). Here:

- a numpy model of kernel F (`csrc/ranksum.cu`): blocks of BLOCK_PAIRS
  pairs, each owning the runs whose head lies in its span (it starts at
  the first run head at or after its nominal start and stops at the first
  at or after its end), windows of THREADS x ITEMS pairs, each thread's
  items summed in order, the segmented scan over a warp's lanes, the warps
  and the windows, in the kernel's own float32 order. It must equal
  `rank_rowsum_plain` (and the JAX fallback) at rtol 1e-4 + atol 1e-5 of
  the largest |sum| (F's tolerance in chip_smoke.py) on runs that
  cross one and several block boundaries, a run longer than three blocks,
  every pair in the discard bucket, empty ranks at both ends; the card's
  kernel equals it bit for bit (tests/test_torch_cuda.py);
- the model's constants are the source's;
- the line replacements of `bwd_ablation.py --kernel fwd` on kernel D's
  source.

This module imports no JAX at its top, so that the card's tests, which
run without JAX, can import the model.
"""
import re

import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu_torch.ops import _cuda, segreduce


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Kernel F: the model.
# ---------------------------------------------------------------------------

THREADS, ITEMS, ROWS = 256, 4, 5
WINDOW = THREADS * ITEMS
BLOCK_PAIRS = WINDOW
WARPS = THREADS // 32


def _first_head(heads_at, p_len, q):
    """The first p >= q that starts a run, or p_len."""
    if q >= p_len:
        return p_len
    i = np.searchsorted(heads_at, q)
    return int(heads_at[i]) if i < heads_at.shape[0] else p_len


def _window(rows, ranks, num_out, s, e, w0, carry, out):
    """One window of one block, all rows at once (a row's arithmetic does
    not depend on the others'). Returns the carry to the next window."""
    f32 = np.float32
    ng = rows.shape[0] - 1
    base = w0 + np.arange(THREADS) * ITEMS                       # (256,)
    idx = base[:, None] + np.arange(ITEMS)                       # (256, 4)
    valid = idx < e
    top = ranks.shape[0] - 1
    r = np.where(valid, ranks[np.minimum(idx, top)], -1)
    prev = np.where((base > s) & (base < e),
                    ranks[np.clip(base - 1, 0, top)], -1)
    nxt = np.where(base + ITEMS < e, ranks[np.minimum(base + ITEMS, top)], -1)
    head = valid & (r != np.concatenate([prev[:, None], r[:, :-1]], 1))
    tail = valid & (r != np.concatenate([r[:, 1:], nxt[:, None]], 1))
    vals = rows[:ng][:, np.minimum(idx, rows.shape[1] - 1)]      # (ng, 256, 4)
    v = np.where(valid[None], vals, f32(0)).astype(f32)
    # The thread's sum from its last head.
    agg = np.zeros((ng, THREADS), f32)
    for k in range(ITEMS):
        agg = np.where(head[None, :, k], v[:, :, k], agg + v[:, :, k])
    has_head = head.any(axis=1)
    # The inclusive segmented scan over each warp's lanes (shuffles up).
    lane = np.arange(THREADS) % 32
    f = has_head.copy()
    a = agg.copy()
    off = 1
    while off < 32:
        f_up = np.roll(f, off)
        a_up = np.roll(a, off, axis=1)
        take = (lane >= off) & ~f
        a = np.where(take[None], a_up + a, a)
        f = np.where(lane >= off, f | f_up, f)
        off *= 2
    ex_f = np.roll(f, 1)
    ex = np.roll(a, 1, axis=1)
    # The window's carry, then the warps before, then the lanes before.
    wc = np.zeros((ng, WARPS), f32)
    c = np.zeros(ng, f32) if w0 == s else carry
    for w in range(WARPS):
        wc[:, w] = c
        last = 32 * w + 31
        c = a[:, last] if f[last] else c + a[:, last]
    wc_t = np.repeat(wc, 32, axis=1)
    run = np.where(lane == 0, wc_t, np.where(ex_f, ex, wc_t + ex)).astype(f32)
    carry_out = agg[:, -1] if has_head[-1] else run[:, -1] + agg[:, -1]
    for k in range(ITEMS):
        run = np.where(head[None, :, k], v[:, :, k], run + v[:, :, k])
        w = tail[:, k] & (r[:, k] >= 0) & (r[:, k] < num_out)
        out[:, r[w, k]] = run[:, w]
    return carry_out


def ranksum_model(rows: np.ndarray, ranks: np.ndarray,
                  num_out: int) -> np.ndarray:
    """What csrc/ranksum.cu computes, in its order of float32 additions:
    rows (C, P) float32 (the last row is not read), ranks (P,) int32
    sorted in [0, num_out] -> (C - 1, num_out)."""
    rows = np.asarray(rows, np.float32)
    ranks = np.asarray(ranks, np.int32)
    p_len = ranks.shape[0]
    out = np.zeros((rows.shape[0] - 1, num_out), np.float32)
    if p_len == 0 or num_out == 0:
        return out
    heads_at = np.flatnonzero(np.concatenate(
        [[True], ranks[1:] != ranks[:-1]]))
    for b in range(-(-p_len // BLOCK_PAIRS)):
        s = _first_head(heads_at, p_len, b * BLOCK_PAIRS)
        e = _first_head(heads_at, p_len, min((b + 1) * BLOCK_PAIRS, p_len))
        carry = None
        for w0 in range(s, e, WINDOW):
            carry = _window(rows, ranks, num_out, s, e, w0, carry, out)
    return out


def _assert_sums_close(got, want):
    """F's tolerance: rtol 1e-4 + atol 1e-5 of the largest |sum| (runs of
    thousands of pairs, summed in another order)."""
    top = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * top)


def _rows(rng, ranks, ng=10):
    vals = rng.standard_normal((ng, ranks.shape[0])).astype(np.float32)
    return np.concatenate([vals, ranks[None].astype(np.float32)])


def _runs(lengths, first=0, gap=1):
    """Sorted ranks: run i has lengths[i] pairs and rank first + gap * i."""
    return np.repeat(first + gap * np.arange(len(lengths)),
                     lengths).astype(np.int32)


def _case(name):
    """(rows, ranks, num_out) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        ranks = np.sort(rng.integers(0, 3001, 12_000)).astype(np.int32)
        return _rows(rng, ranks), ranks, 3000
    if name == "crossing":
        # Runs of 300..2,500 pairs: many cross one block boundary, some two.
        ranks = _runs(rng.integers(300, 2500, 20), first=3, gap=7)
        return _rows(rng, ranks), ranks, 7 * 20 + 9
    if name == "long":
        # One run longer than three blocks among short ones.
        lens = np.concatenate([rng.integers(1, 40, 50),
                               [3 * BLOCK_PAIRS + 517],
                               rng.integers(1, 40, 50)])
        ranks = _runs(lens, first=0, gap=3)
        return _rows(rng, ranks), ranks, 3 * 101
    if name == "discard":
        ranks = np.full(5000, 777, np.int32)
        return _rows(rng, ranks), ranks, 777
    if name == "empty_ends":
        # Ranks without pairs at both ends, and a discard tail; num_out is
        # not a multiple of anything in the kernel.
        ranks = np.sort(rng.integers(40, 2960, 9000)).astype(np.int32)
        ranks = np.concatenate([ranks, np.full(1500, 3001, np.int32)])
        return _rows(rng, ranks), ranks, 3001
    if name == "one_pair":
        ranks = np.array([4], np.int32)
        return _rows(rng, ranks), ranks, 5
    if name == "block_aligned":
        # Every run head on a block boundary, and runs of exactly a block.
        ranks = _runs([BLOCK_PAIRS] * 3 + [1, BLOCK_PAIRS - 1, 2 * BLOCK_PAIRS])
        return _rows(rng, ranks), ranks, 6
    raise KeyError(name)


F_CASES = ["random", "crossing", "long", "discard", "empty_ends", "one_pair",
           "block_aligned"]


@pytest.mark.parametrize("name", F_CASES)
def test_ranksum_model_matches_plain(name):
    rows, ranks, num_out = _case(name)
    got = ranksum_model(rows, ranks, num_out)
    want = segreduce.rank_rowsum_plain(torch.from_numpy(rows),
                                       torch.from_numpy(ranks), num_out)
    assert got.shape == tuple(want.shape)
    _assert_sums_close(got, want.numpy())
    # The ranks without pairs and the discard bucket stay zero.
    owned = np.zeros(num_out, bool)
    owned[ranks[ranks < num_out]] = True
    assert not got[:, ~owned].any()
    if name == "discard":
        assert not got.any()


def test_ranksum_model_cases_reach_what_they_name():
    heads = {}
    for name in F_CASES:
        _, ranks, num_out = _case(name)
        lens = np.bincount(ranks, minlength=num_out + 1)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        live = (lens > 0) & (np.arange(num_out + 1) < num_out)
        first_block = starts // BLOCK_PAIRS
        last_block = (starts + lens - 1) // BLOCK_PAIRS
        heads[name] = (lens[live], (last_block - first_block)[live])
    assert (heads["crossing"][1] == 1).any() and (heads["crossing"][1] >= 2).any()
    assert heads["long"][0].max() > 3 * BLOCK_PAIRS
    assert heads["discard"][0].size == 0
    _, ranks, num_out = _case("empty_ends")
    assert ranks.min() > 0 and ranks[ranks < num_out].max() < num_out - 1
    assert num_out % BLOCK_PAIRS and num_out % THREADS


@pytest.mark.parametrize("name", ["random", "long", "empty_ends"])
def test_ranksum_model_matches_jax_fallback(name):
    import jax.numpy as jnp
    from street_gaussians_ns_tpu.ops import segreduce_pallas as jseg
    from test_torch_backward import T

    rows, ranks, num_out = _case(name)
    got = ranksum_model(rows, ranks, num_out)
    want = jseg.rank_rowsum(jnp.asarray(rows), jnp.asarray(ranks), num_out)
    _assert_sums_close(got, np.asarray(want))
    # And the port's wrapper (the plain version on the CPU) agrees with
    # both through the same helpers.
    plain = segreduce.rank_rowsum(T(rows), T(ranks), num_out)
    _assert_sums_close(plain.numpy(), np.asarray(want))


def test_ranksum_model_order_is_the_blocks_not_the_pairs():
    """A run that crosses blocks is summed in the kernel's order, which
    differs from a sequential sum in some last bits: the card's kernel is
    held to the model bit for bit, and to the plain version at rtol."""
    rows, ranks, num_out = _case("long")
    got = ranksum_model(rows, ranks, num_out)
    seq = np.zeros_like(got)
    for p in range(ranks.shape[0]):
        if ranks[p] < num_out:
            seq[:, ranks[p]] += rows[:-1, p]
    assert not np.array_equal(got, seq)
    _assert_sums_close(got, seq)


def test_ranksum_model_constants_are_the_sources():
    src = (_cuda.CSRC / "ranksum.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert consts["THREADS"] == str(THREADS)
    assert consts["ITEMS"] == str(ITEMS)
    assert consts["ROWS"] == str(ROWS)
    assert consts["WINDOW"] == "THREADS * ITEMS"
    assert consts["BLOCK_PAIRS"] == "WINDOW"


# ---------------------------------------------------------------------------
# The ablation script's scratch copies of kernel D still find their lines.
# ---------------------------------------------------------------------------

def test_fwd_ablation_patches_apply_to_the_shipped_kernel():
    """bwd_ablation.py --kernel fwd times copies of csrc/composite_fwd.cu
    with a few lines replaced; an edit of the kernel that moves those
    lines must show here, not on the card."""
    import bwd_ablation as ab
    shipped = ab.FWD_SHIPPED.read_text()
    seen = set()
    for name, (first_version, switches, _) in ab.FWD_VARIANTS.items():
        if first_version:
            continue
        text = ab.patched(ab.FWD_SHIPPED, switches, ab.FWD_PATCHES)
        assert "abl_set" in text and text != shipped
        assert ("clock64()" in text) == ("clock" in switches)
        seen.add(text)
    assert len(seen) == sum(not v[0] for v in ab.FWD_VARIANTS.values())
    with pytest.raises(ValueError):
        ab.patched(ab.FWD_SHIPPED, ("slot",), ab.FWD_PATCHES)

