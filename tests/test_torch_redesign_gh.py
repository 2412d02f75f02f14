"""What the CPU can reach of the redesigned kernels H (row scan) and G
(segment sum) of the port.

The CUDA sources run on the card only (tests/test_torch_cuda.py). Here:

- `rowscan_model`, a numpy model of kernel H (`csrc/scan_rows.cu`): tiles
  of 256 x (32 // C) rows taken by ticket, each thread's rows scanned in
  its registers, the column scans over the threads (8 totals a lane, then
  a Hillis-Steele scan over 32 lanes), and the look-back over one 8-byte
  {tag, state, value} word a column and tile, 32 tiles a round and up to
  WINDOWS rounds kept, run under seeded random interleavings of the
  blocks. int32 add and max and float32 max are exact; the float32 add
  gives the same bits under every interleaving, and its published running
  totals are the left fold of the tile totals; a second launch on the
  same scratch is right without clearing it (the tags); a writer that
  stored a state before its value would be read torn. The card's kernel
  equals the model bit for bit;
- `segsum_model`, a numpy model of kernel G (`csrc/segsum.cu`): groups of
  GROUP segments, each group's span over its non-empty runs cut into
  windows of 32 x ITEMS pairs, each window summing the runs whose head
  lies in it, a CHUNK at a time, with the run heads and ends marked from
  the bounds and F's segmented scan over a warp in its float32 order. Its
  cases: runs across group and window boundaries, a run longer than a
  group's span and than many windows, empty runs at the start, the end
  and the middle with arbitrary starts, every run empty, clipped bounds,
  gaps, C from 1 to 16;
- both models against the port's plain versions and the JAX fallbacks
  (`jnp.cumsum` / `lax.cummax`, `segment_rowsum`) at the tolerances of
  tests/test_torch_scan_rows.py and tests/test_torch_segsum.py;
- the models' constants are the sources';
- the line replacements of `bwd_ablation.py --kernel rowscan` and
  `--kernel segsum`.

This module imports no JAX at its top, so that the card's tests, which
run without JAX, can import the models.
"""
import re

import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu_torch.ops import _cuda, scan, segreduce


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _consts(source):
    text = (_cuda.CSRC / source).read_text()
    return dict(re.findall(r"constexpr int (\w+) = ([^;]+);", text))


# ---------------------------------------------------------------------------
# Kernel H: the model.
# ---------------------------------------------------------------------------

H_THREADS, H_PER_THREAD, H_WINDOWS = 256, 32, 4
LANES = 32

H_OPS = {
    ("int32", "add"): (np.int32, np.add, np.int32(0)),
    ("int32", "max"): (np.int32, np.maximum, np.iinfo(np.int32).min),
    ("float32", "add"): (np.float32, np.add, np.float32(0)),
    ("float32", "max"): (np.float32, np.maximum, np.float32(-np.inf)),
}


def _tile_locals(x, op, ident):
    """Every tile's work before the look-back, in the kernel's order:
    (v, excl, agg): v (tiles, THREADS, RPT, C) the threads' rows scanned
    in registers, excl (tiles, THREADS, C) each thread's exclusive prefix
    within its tile, agg (tiles, C) the tile's column totals."""
    m, c = x.shape
    dt = x.dtype
    rpt = H_PER_THREAD // c
    rows = H_THREADS * rpt
    tiles = -(-m // rows)
    xp = np.full((tiles * rows, c), ident, dt)
    xp[:m] = x
    with np.errstate(over="ignore"):
        v = op.accumulate(xp.reshape(tiles, H_THREADS, rpt, c), axis=2,
                          dtype=dt)
        tot = v[:, :, -1, :]                                # (t, 256, C)
        k = H_THREADS // LANES
        r = op.accumulate(tot.reshape(tiles, LANES, k, c), axis=2, dtype=dt)
        t = r[:, :, -1, :].copy()                           # (t, 32, C)
        off = 1
        while off < LANES:
            up = np.concatenate([np.full_like(t[:, :off], ident),
                                 t[:, :-off]], axis=1)
            lane = np.arange(LANES)[None, :, None]
            t = np.where(lane >= off, op(up, t), t)
            off *= 2
        ex = np.concatenate([np.full_like(t[:, :1], ident), t[:, :-1]], 1)
        excl = np.empty_like(r)
        excl[:, :, 0] = ex
        excl[:, :, 1:] = op(ex[:, :, None], r[:, :, :-1])
    return v, excl.reshape(tiles, H_THREADS, c), t[:, -1, :].copy()


class ProtocolError(AssertionError):
    pass


def _h_block(st, agg, op, windows, broken):
    """One block's look-back as a generator that yields wherever the card
    could run another block first. st, the scratch: "ticket", "done",
    "launches" (the counters) and "desc" [tile][column] -> (tag, inclusive,
    value), each entry one 8-byte word, stored and loaded whole; results go
    to st["prefix"][tile] and st["met"][tile] (the tile each column's
    INCLUSIVE was met at)."""
    tile = st["ticket"]
    st["ticket"] += 1
    tag = (st["launches"] & 0x3FFFFFFF) + 1
    yield
    desc = st["desc"]
    c = agg.shape[1]

    def publish(col, inclusive, value):
        if broken:      # the state stored before the value, in two halves
            desc[tile][col] = (tag, inclusive, None)
            yield
        desc[tile][col] = (tag, inclusive, value)

    def peek(t, col):
        if t < 0:       # before the first tile: an AGGREGATE, never used
            return (tag, False, None)
        return desc[t][col]

    # Each lane stores its column's word; another block may run between
    # two of them.
    for col in range(c):
        yield from publish(col, tile == 0, agg[tile][col])
        yield
    prefix = None
    if tile > 0:
        todo = set(range(c))
        win = {}                         # (slot, lane, col) -> value
        where = {}                       # col -> (slot, lane)
        w = 0
        while todo:
            slot = min(w, windows - 1)
            ts = [tile - 1 - LANES * w - lane for lane in range(LANES)]
            while True:
                words = [[peek(t, col) for col in range(c)] for t in ts]
                if all(d is not None and d[0] == tag
                       for row in words for d in row):
                    break
                yield
            for col in range(c):
                if col not in todo:
                    continue
                incl = [lane for lane in range(LANES) if words[lane][col][1]]
                for lane in range(LANES):
                    win[slot, lane, col] = words[lane][col][2]
                if incl:
                    todo.discard(col)
                    where[col] = (slot, incl[0])
            if w < windows - 1 or not todo:
                w += 1
            else:
                st["repolls"] += 1
            yield
        prefix = np.empty(c, agg.dtype)
        st["met"][tile] = {}
        with np.errstate(over="ignore"):
            for col in range(c):
                slot, f = where[col]
                st["met"][tile][col] = tile - 1 - LANES * slot - f
                order = [(slot, f)] + [(slot, lane)
                                       for lane in range(f - 1, -1, -1)]
                for r in range(slot - 1, -1, -1):
                    order += [(r, lane) for lane in range(LANES - 1, -1, -1)]
                vals = [win[r, lane, col] for r, lane in order]
                if any(v is None for v in vals):
                    raise ProtocolError(f"tile {tile} folds a value that "
                                        f"was not yet written")
                p = vals[0]
                for v in vals[1:]:
                    p = op(p, v)
                prefix[col] = p
            inc = op(prefix, agg[tile])
        for col in range(c):
            yield from publish(col, True, inc[col])
            yield
    st["done"] += 1
    st["prefix"][tile] = prefix
    if st["done"] == len(agg):
        st["ticket"] = st["done"] = 0
        st["launches"] += 1


def rowscan_model(x, opname, seed=None, resident=7, broken=False,
                  scratch=None, windows=H_WINDOWS):
    """What csrc/scan_rows.cu computes: x (M, C <= 16) int32 or float32,
    opname "add" or "max". With `seed` the blocks' look-backs run under a
    seeded random interleaving of at most `resident` blocks (a block takes
    its ticket when it starts); without, each tile finds its predecessor's
    INCLUSIVE. Returns (out, scratch); scratch["inclusive"] holds the
    published running totals (tiles, C)."""
    x = np.asarray(x)
    _, op, ident = H_OPS[(str(x.dtype), opname)]
    m, c = x.shape
    v, excl, agg = _tile_locals(x, op, ident)
    tiles = agg.shape[0]
    if scratch is None:
        scratch = {"ticket": 0, "done": 0, "launches": 0, "desc": []}
    assert scratch["ticket"] == 0 and scratch["done"] == 0
    # Descriptors of earlier launches stay: their tags retire them.
    while len(scratch["desc"]) < tiles:
        scratch["desc"].append([(0, False, 0)] * 16)
    scratch["prefix"], scratch["met"], scratch["repolls"] = {}, {}, 0
    if tiles == 1 or seed is None:
        inc = agg[0]
        scratch["prefix"][0] = None
        incs = [inc]
        with np.errstate(over="ignore"):
            for t in range(1, tiles):
                scratch["prefix"][t] = inc
                inc = op(inc, agg[t])
                incs.append(inc)
        scratch["inclusive"] = np.stack(incs)
    else:
        rng = np.random.default_rng(seed)
        waiting, running = tiles, []
        while waiting or running:
            if waiting and (len(running) < resident and
                            (not running or rng.random() < 0.5)):
                g = _h_block(scratch, agg, op, windows, broken)
                next(g)
                running.append(g)
                waiting -= 1
                continue
            i = int(rng.integers(len(running)))
            try:
                next(running[i])
            except StopIteration:
                running.pop(i)
        scratch["inclusive"] = np.stack([[scratch["desc"][t][col][2]
                                          for col in range(c)]
                                         for t in range(tiles)])
    # The first tile's prefix is the identity, which the kernel applies
    # too (0 + x is x but for x = -0).
    prefix = np.stack([np.full(c, ident, x.dtype) if scratch["prefix"][t]
                       is None else scratch["prefix"][t]
                       for t in range(tiles)])
    with np.errstate(over="ignore"):
        pre = op(prefix[:, None, :], excl)
        out = op(pre[:, :, None, :], v).reshape(-1, c)[:m]
    return out, scratch


def _h_input(m, c, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(-50, 1000, size=(m, c)).astype(np.int32)
        x[rng.random((m, c)) < 0.7] = -1
        return x
    return rng.standard_normal((m, c)).astype(np.float32)


def _h_plain(x, opname):
    t = torch.from_numpy(x)
    return (scan.cumsum_rows_plain(t) if opname == "add"
            else scan.cummax_rows_plain(t)).numpy()


def _h_close(got, x):
    """The float32 sum: rtol 1e-5 of the column's largest running
    magnitude, against a float64 sum (H's tolerance)."""
    want = np.cumsum(x.astype(np.float64), axis=0)
    top = np.abs(want).max(axis=0, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * top + 1e-6).all()


def h_rows(c):
    return scan.rows_per_tile(c)


# M under one tile, exactly one, one more, and several tiles with a ragged
# end, for every C.
H_SHAPES = [(c, m) for c in range(1, 17)
            for m in (1, h_rows(c) - 3, 5 * h_rows(c) + 17)] + \
    [(6, h_rows(6)), (16, h_rows(16) + 1), (16, 40 * h_rows(16) + 5)]


@pytest.mark.parametrize("c,m", H_SHAPES)
@pytest.mark.parametrize("dtype,opname", [("int32", "add"), ("int32", "max"),
                                          ("float32", "max")])
def test_rowscan_model_is_exact(c, m, dtype, opname):
    x = _h_input(m, c, dtype, 7 * c + m)
    got, st = rowscan_model(x, opname, seed=c + m)
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(got, _h_plain(x, opname))
    if len(st["desc"]) > 1:
        # The last block reset the counters and moved the launch count on;
        # a second launch on the scratch as it was left, its descriptors
        # uncleared, under another interleaving, gives the same result.
        assert st["launches"] == 1
        again, _ = rowscan_model(x, opname, seed=m + 1, resident=3,
                                 scratch=st)
        np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("c,m", [(1, 9 * h_rows(1) + 3), (6, 1000),
                                 (6, 33 * h_rows(6) + 11),
                                 (16, 40 * h_rows(16) + 5),
                                 (11, 7 * h_rows(11))])
def test_rowscan_model_float_add_is_the_left_fold(c, m):
    """The float32 sum has one result under every interleaving: each
    tile's published running total is bit for bit the sequential fold of
    the tile totals, whichever predecessor's total its look-back met."""
    x = (_h_input(m, c, "float32", c) * 100).astype(np.float32)
    outs, incs = set(), set()
    for seed, resident in ((None, 1), (1, 2), (2, 7), (3, 33), (4, 64)):
        got, st = rowscan_model(x, "add", seed=seed, resident=resident)
        outs.add(got.tobytes())
        incs.add(st["inclusive"].tobytes())
    assert len(outs) == 1 and len(incs) == 1
    _, op, ident = H_OPS[("float32", "add")]
    _, _, agg = _tile_locals(x, op, ident)
    np.testing.assert_array_equal(st["inclusive"],
                                  np.add.accumulate(agg, axis=0))
    _h_close(got, x)


def test_rowscan_model_lookback_meets_many_predecessors():
    """With many blocks resident the look-back walks past AGGREGATEs, some
    tiles past a whole round of 32: the fold is then longer than one tile,
    and every prefix still has the bits of its predecessor's running
    total."""
    c, m = 16, 150 * h_rows(16)
    x = _h_input(m, c, "float32", 3)
    got, st = rowscan_model(x, "add", seed=5, resident=140)
    want, _ = rowscan_model(x, "add")
    np.testing.assert_array_equal(got, want)
    dist = np.array([t - j for t, met in st["met"].items()
                     for j in met.values()])
    assert dist.max() > LANES and (dist == 1).any()
    inc = st["inclusive"]
    for t in range(1, inc.shape[0]):
        assert np.array_equal(st["prefix"][t], inc[t - 1])


@pytest.mark.parametrize("windows", [1, 2])
def test_rowscan_model_waits_on_the_oldest_round_kept(windows):
    """Fewer rounds kept than the look-back needs: a column waits on the
    oldest round until an INCLUSIVE appears there, and the bits stay."""
    c, m = 6, 120 * h_rows(6)
    x = (_h_input(m, c, "float32", 4) * 10).astype(np.float32)
    want, _ = rowscan_model(x, "add")
    got, st = rowscan_model(x, "add", seed=6, resident=120, windows=windows)
    np.testing.assert_array_equal(got, want)
    assert st["repolls"] > 0


def test_rowscan_model_never_reads_a_value_without_its_state():
    """A column's state and value are one word, stored and loaded whole;
    a writer that stored the state before the value would be read torn
    under some interleaving."""
    c, m = 8, 30 * h_rows(8)
    x = _h_input(m, c, "float32", 1)
    for seed in range(4):
        rowscan_model(x, "add", seed=seed, resident=16)
    caught = 0
    for seed in range(20):
        try:
            rowscan_model(x, "add", seed=seed, resident=16, broken=True)
        except ProtocolError:
            caught += 1
    assert caught > 0


def test_rowscan_model_int32_sum_wraps():
    x = np.full((3 * h_rows(2), 2), 2 ** 29, np.int32)
    got, _ = rowscan_model(x, "add", seed=0)
    np.testing.assert_array_equal(got, np.cumsum(x, axis=0, dtype=np.int32))


@pytest.mark.parametrize("c", [1, 6, 8, 16])
def test_rowscan_model_matches_jax_fallback(c):
    import jax.numpy as jnp
    from jax import lax

    m = 3 * h_rows(c) + 29
    xi = _h_input(m, c, "int32", c)
    for opname, want in (("add", jnp.cumsum(jnp.asarray(xi), axis=0)),
                         ("max", lax.cummax(jnp.asarray(xi), axis=0))):
        got, _ = rowscan_model(xi, opname, seed=c)
        np.testing.assert_array_equal(got, np.asarray(want))
    xf = _h_input(m, c, "float32", c + 1)
    got, _ = rowscan_model(xf, "max", seed=c)
    np.testing.assert_array_equal(
        got, np.asarray(lax.cummax(jnp.asarray(xf), axis=0)))
    got, _ = rowscan_model(xf, "add", seed=c)
    want = np.asarray(jnp.cumsum(jnp.asarray(xf), axis=0))
    top = np.abs(want).max(axis=0, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * top).all()


def test_rowscan_model_constants_are_the_sources():
    consts = _consts("scan_rows.cu")
    assert consts["THREADS"] == str(H_THREADS) == str(scan._ROWS_THREADS)
    assert consts["PER_THREAD"] == str(H_PER_THREAD) \
        == str(scan._ROWS_PER_THREAD)
    assert consts["WINDOWS"] == str(H_WINDOWS)
    assert consts["HEAD_WORDS"] == str(scan._ROWS_HEAD)
    assert consts["MAX_C"] == str(scan._ROWS_SLOTS) == "16"


@pytest.mark.parametrize("m,c,words", [
    (1, 6, 0), (1280, 6, 0), (1281, 6, 2 + 2 * 16),
    (4_456_448, 16, 2 + 8704 * 16), (4_456_448, 6, 2 + 3482 * 16)])
def test_rowscan_scratch_len(m, c, words):
    assert scan._rows_scratch_len(m, c) == words


def test_rowscan_scratch_is_per_stream_and_apart_from_the_flat_scans(
        monkeypatch):
    monkeypatch.setattr(scan, "_scratch", {})
    monkeypatch.setattr(scan, "_rows_scratch", {})
    cpu = torch.device("cpu")
    a = scan._scratch_for(cpu, 11, 500, scan._rows_scratch)
    assert not a.any() and a.dtype == torch.int64
    assert scan._scratch_for(cpu, 11, 40, scan._rows_scratch) is a
    flat = scan._scratch_for(cpu, 11, 500)
    assert flat is not a and not scan._scratch_for(cpu, 12, 1).any()
    assert len(scan._rows_scratch) == 1 and len(scan._scratch) == 2


# ---------------------------------------------------------------------------
# Kernel G: the model.
# ---------------------------------------------------------------------------

G_THREADS, G_ITEMS, G_GROUP, G_ROWS = 128, 4, 128, 5
G_CHUNK = 32 * G_ITEMS


def _g_chunk(rows, base, last, head, tail, carry, out, g0):
    """One CHUNK of one window, all rows at once (a row's arithmetic does
    not depend on the others'): base, the chunk's first pair; head (CHUNK,)
    bool, tail (CHUNK,) the group's segment ending at each pair or -1.
    Returns the carry to the next chunk."""
    f32 = np.float32
    c, p_len = rows.shape
    idx = base + np.arange(G_CHUNK).reshape(32, G_ITEMS)
    valid = idx < last
    hd = head.reshape(32, G_ITEMS) & valid
    tl = np.where(valid, tail.reshape(32, G_ITEMS), -1)
    vals = rows[:, np.minimum(idx, max(p_len - 1, 0))]
    v = np.where(valid[None], vals, f32(0)).astype(f32)
    agg = np.zeros((c, 32), f32)
    for k in range(G_ITEMS):
        agg = np.where(hd[None, :, k], v[:, :, k], agg + v[:, :, k])
    has_head = hd.any(axis=1)
    lane = np.arange(32)
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
    cr = carry[:, None]
    run = np.where(lane == 0, cr, np.where(ex_f, ex, cr + ex)).astype(f32)
    carry_out = agg[:, -1] if has_head[-1] else run[:, -1] + agg[:, -1]
    for k in range(G_ITEMS):
        run = np.where(hd[None, :, k], v[:, :, k], run + v[:, :, k])
        w = tl[:, k] >= 0
        out[:, g0 + tl[w, k]] = run[:, w]
    return carry_out.astype(f32)


def segsum_model(rows, starts, ends):
    """What csrc/segsum.cu computes, in its order of float32 additions:
    rows (C, P) float32, starts and ends (S,) int32 -> (C, S). Windows are
    independent of each other, so the model takes them in order."""
    rows = np.asarray(rows, np.float32)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    c, p_len = rows.shape
    n = starts.shape[0]
    out = np.full((c, n), np.nan, np.float32)    # every column is written
    lo = np.clip(starts, 0, p_len)
    hi = np.minimum(np.maximum(ends, lo), p_len)
    for g0 in range(0, n, G_GROUP):
        glo, ghi = lo[g0:g0 + G_GROUP], hi[g0:g0 + G_GROUP]
        live = ghi > glo
        out[:, g0 + np.flatnonzero(~live)] = 0.0
        if not live.any():
            continue
        s, e = int(glo[live].min()), int(ghi[live].max())
        for w0 in range(s, e, G_CHUNK):
            own = np.flatnonzero(live & (glo >= w0) & (glo < w0 + G_CHUNK))
            if own.size == 0:
                continue
            first, last = int(glo[own].min()), int(ghi[own].max())
            carry = np.zeros(c, np.float32)
            for u0 in range(first, last, G_CHUNK):
                head = np.zeros(G_CHUNK, bool)
                tail = np.full(G_CHUNK, -1, np.int64)
                h = glo[own] - u0
                inw = (h >= 0) & (h < G_CHUNK)
                head[h[inw]] = True
                t = ghi[own] - 1 - u0
                inw = (t >= 0) & (t < G_CHUNK)
                tail[t[inw]] = own[inw]
                carry = _g_chunk(rows, u0, last, head, tail, carry, out, g0)
    return out


def _g_close(got, want):
    """G's tolerance: rtol 1e-4 + atol 1e-5 of the largest |sum|."""
    top = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * max(top, 1.0))


def _g_runs(rng, counts, gaps=None):
    """starts, ends of ascending runs of `counts` pairs; gaps[i] pairs
    left out before run i. Empty runs get a random start (any start is
    allowed for them)."""
    counts = np.asarray(counts, np.int64)
    gaps = np.zeros_like(counts) if gaps is None else np.asarray(gaps)
    ends = np.cumsum(counts + gaps)
    starts = ends - counts
    empty = counts == 0
    starts[empty] = rng.integers(0, max(int(ends[-1]), 1) + 50, empty.sum())
    ends[empty] = starts[empty]
    return starts.astype(np.int32), ends.astype(np.int32), int(ends[-1])


def g_case(name):
    """(rows, starts, ends) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    c = 10
    if name == "random":
        counts = rng.integers(1, 9, 3000)
        counts[rng.random(3000) < 0.25] = 0
        starts, ends, p = _g_runs(rng, counts)
    elif name == "crossing":
        # Runs of 100..900 pairs: groups span several windows, and runs
        # cross window boundaries.
        counts = rng.integers(100, 900, 700)
        starts, ends, p = _g_runs(rng, counts)
    elif name == "long":
        # One run longer than a window and than a group's whole span,
        # among short ones, in the middle of a group.
        counts = rng.integers(0, 6, 800)
        counts[300] = 28 * G_CHUNK + 5
        starts, ends, p = _g_runs(rng, counts)
    elif name == "empty_anywhere":
        # Empty runs at the start, the end and the middle, with starts
        # anywhere (before, inside, past the covered pairs); whole groups
        # empty.
        counts = rng.integers(1, 7, 2000)
        counts[:300] = 0
        counts[-400:] = 0
        counts[rng.random(2000) < 0.3] = 0
        counts[700:700 + 2 * G_GROUP] = 0      # a whole group at least
        starts, ends, p = _g_runs(rng, counts)
    elif name == "all_empty":
        starts = rng.integers(-5, 100, 700).astype(np.int32)
        ends, p = starts.copy(), 90
    elif name == "clipped":
        # Bounds past both ends of the rows: clipped to [0, P].
        counts = rng.integers(1, 9, 600)
        starts, ends, p = _g_runs(rng, counts)
        p -= 37
        starts[0] = -20
        ends[-3:] += 11
    elif name == "gaps":
        counts = rng.integers(1, 9, 1500)
        counts[rng.random(1500) < 0.2] = 0
        gaps = rng.integers(0, 4, 1500) * (rng.random(1500) < 0.3)
        gaps[700] = 3000                        # a gap wider than a window
        starts, ends, p = _g_runs(rng, counts, gaps)
    elif name == "one_pair":
        starts, ends, p = (np.array([0], np.int32), np.array([1], np.int32),
                           1)
    else:
        raise KeyError(name)
    rows = rng.standard_normal((c, max(p, 0))).astype(np.float32)
    return rows, starts, ends


G_CASES = ["random", "crossing", "long", "empty_anywhere", "all_empty",
           "clipped", "gaps", "one_pair"]


@pytest.mark.parametrize("name", G_CASES)
def test_segsum_model_matches_plain(name):
    rows, starts, ends = g_case(name)
    got = segsum_model(rows, starts, ends)
    want = segreduce.segment_rowsum_plain(
        torch.from_numpy(rows), torch.from_numpy(starts),
        torch.from_numpy(ends)).numpy()
    assert got.shape == want.shape and not np.isnan(got).any()
    _g_close(got, want)
    lo = np.clip(starts, 0, rows.shape[1])
    empty = np.minimum(np.maximum(ends, lo), rows.shape[1]) == lo
    assert not got[:, empty].any()
    if name == "all_empty":
        assert not got.any()


def test_segsum_model_cases_reach_what_they_name():
    def spans(name):
        rows, starts, ends = g_case(name)
        p = rows.shape[1]
        lo = np.clip(starts.astype(np.int64), 0, p)
        hi = np.minimum(np.maximum(ends.astype(np.int64), lo), p)
        return lo, hi, p
    lo, hi, _ = spans("crossing")
    assert ((lo // G_CHUNK) != ((hi - 1) // G_CHUNK)).any()
    lo, hi, _ = spans("long")
    assert (hi - lo).max() > 28 * G_CHUNK
    lo, hi, p = spans("empty_anywhere")
    empty = hi == lo
    assert empty[:10].all() and empty[-10:].all()
    assert (lo[empty] > 0).any() and (lo[empty] == p).any()
    assert any(empty[g:g + G_GROUP].all()
               for g in range(0, empty.shape[0], G_GROUP))
    _, starts, ends = g_case("clipped")
    rows, _, _ = g_case("clipped")
    assert starts.min() < 0 and ends.max() > rows.shape[1]
    lo, hi, _ = spans("gaps")
    live = hi > lo
    assert (lo[live][1:] > hi[live][:-1]).any()


@pytest.mark.parametrize("c", list(range(1, 17)))
def test_segsum_model_every_width(c):
    rng = np.random.default_rng(c)
    counts = rng.integers(0, 12, 700)
    counts[rng.random(700) < 0.25] = 0
    starts, ends, p = _g_runs(rng, counts)
    rows = rng.standard_normal((c, p)).astype(np.float32)
    got = segsum_model(rows, starts, ends)
    want = segreduce.segment_rowsum_plain(
        torch.from_numpy(rows), torch.from_numpy(starts),
        torch.from_numpy(ends)).numpy()
    _g_close(got, want)


@pytest.mark.parametrize("name", ["random", "long", "empty_anywhere",
                                  "gaps"])
def test_segsum_model_matches_jax_fallback(name):
    import jax.numpy as jnp
    from street_gaussians_ns_tpu.ops import segreduce_pallas as jseg

    rows, starts, ends = g_case(name)
    # The JAX fallback takes bounds inside [0, P] with empty runs' starts
    # anywhere in it.
    p = rows.shape[1]
    starts, ends = np.clip(starts, 0, p), np.clip(ends, 0, p)
    got = segsum_model(rows, starts, ends)
    want = np.asarray(jseg.segment_rowsum(
        jnp.asarray(rows), jnp.asarray(starts), jnp.asarray(ends)))
    top = float(np.abs(want).max())
    # The fallback differences two prefix sums (tests/test_torch_segsum.py):
    # atol 1e-5 of the largest |sum|.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * top)


def test_segsum_model_order_is_the_windows_not_the_pairs():
    """A run that crosses threads is summed in the kernel's order, which
    differs from a sequential sum in some last bits: the card's kernel is
    held to the model bit for bit, and to the plain version at rtol."""
    rows, starts, ends = g_case("crossing")
    got = segsum_model(rows, starts, ends)
    serial = np.zeros_like(got)
    for i, (s, e) in enumerate(zip(starts, ends)):
        acc = np.zeros(rows.shape[0], np.float32)
        for p in range(s, e):
            acc = acc + rows[:, p]
        serial[:, i] = acc
    assert not np.array_equal(got, serial)
    _g_close(got, serial)


def test_segsum_model_constants_are_the_sources():
    consts = _consts("segsum.cu")
    assert consts["THREADS"] == str(G_THREADS)
    assert consts["ITEMS"] == str(G_ITEMS)
    assert consts["GROUP"] == str(G_GROUP)
    assert consts["ROWS"] == str(G_ROWS)
    assert consts["CHUNK"] == "32 * ITEMS"


# ---------------------------------------------------------------------------
# The ablation script's scratch copies of kernels G and H still find their
# lines.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["segsum", "rowscan"])
def test_gh_ablation_patches_apply_to_the_shipped_kernels(kernel):
    """bwd_ablation.py --kernel segsum / rowscan times copies of
    csrc/segsum.cu / scan_rows.cu with a few lines replaced; an edit of a
    kernel that moves those lines must show here, not on the card."""
    import bwd_ablation as ab
    variants, patches, shipped, _, _ = ab.MODES[kernel]
    text0 = shipped.read_text()
    seen = set()
    for name, (first_version, switches, _) in variants.items():
        if first_version:
            continue
        text = ab.patched(shipped, switches, patches)
        assert "abl_set" in text and text != text0
        assert ("clock64()" in text) == bool({"clock", "stats"} &
                                             set(switches))
        seen.add(text)
    assert len(seen) == sum(not v[0] for v in variants.values())
