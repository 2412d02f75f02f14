"""The port's segmented row sum (ops/segreduce.segment_rowsum, kernel G)
against the JAX package on the same numpy inputs, on the CPU, where the
wrapper runs its plain PyTorch version (`index_add_` over
`repeat_interleave`d segment ids).

Tolerance: float32 sums of up to a few dozen O(1) values taken in another
order (the JAX fallback differences two prefix sums, the Pallas body
contracts a one-hot), so atol 1e-5 of the largest |sum| and, against the
numpy oracle in float64, rtol 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.ops import segreduce_pallas as jseg
from street_gaussians_ns_tpu_torch.ops import segreduce as tseg


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


def _segments(seed, n_seg, c, lead_empty=0, trail_empty=0, p_empty=0.2,
              max_count=40):
    """Contiguous ascending runs with empty ones at the front, at the back
    and in between; a few runs longer than a warp's 32."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_count, size=n_seg)
    counts[rng.random(n_seg) < p_empty] = 0
    counts[:lead_empty] = 0
    if trail_empty:
        counts[-trail_empty:] = 0
    ends = np.cumsum(counts).astype(np.int32)
    starts = (ends - counts).astype(np.int32)
    rows = rng.standard_normal((c, int(ends[-1]))).astype(np.float32)
    return rows, starts, ends


def _oracle(rows, starts, ends):
    p_len = rows.shape[1]
    out = np.zeros((rows.shape[0], len(starts)))
    for i, (s, e) in enumerate(zip(starts, ends)):
        s, e = np.clip(s, 0, p_len), np.clip(e, 0, p_len)
        out[:, i] = rows[:, s:e].astype(np.float64).sum(axis=1)
    return out


CASES = [(0, 500, 10, 0, 0), (1, 2500, 16, 7, 0), (2, 900, 4, 0, 11),
         (3, 300, 10, 5, 5)]


@pytest.mark.parametrize("seed,n_seg,c,lead,trail", CASES)
def test_segment_rowsum_matches_jax_fallback(seed, n_seg, c, lead, trail):
    rows, starts, ends = _segments(seed, n_seg, c, lead, trail)
    got = tseg.segment_rowsum(T(rows), T(starts), T(ends))
    want = np.asarray(jseg.segment_rowsum(
        jnp.asarray(rows), jnp.asarray(starts), jnp.asarray(ends)))
    assert tuple(got.shape) == (c, n_seg)
    top = float(np.abs(want).max())
    assert top > 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * top, rtol=0)
    np.testing.assert_allclose(got.numpy(), _oracle(rows, starts, ends),
                               rtol=1e-6, atol=1e-6 * top)


def test_segment_rowsum_matches_pallas_interpret():
    rows, starts, ends = _segments(3, 300, 10, 5, 5)
    got = tseg.segment_rowsum(T(rows), T(starts), T(ends))
    want = np.asarray(jseg.segment_rowsum(
        jnp.asarray(rows), jnp.asarray(starts), jnp.asarray(ends),
        interpret=True))
    top = float(np.abs(want).max())
    # The Pallas body's MXU contraction rounds as the backend's default
    # matmul precision does; on the CPU that is float32.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * top, rtol=0)


def test_segment_rowsum_clips_bounds_and_takes_empty():
    rows = np.ones((2, 10), np.float32)
    starts = np.array([0, 4, 4, 8, 12], np.int32)
    ends = np.array([4, 4, 8, 14, 15], np.int32)     # clipped to 10
    got = tseg.segment_rowsum(T(rows), T(starts), T(ends))
    np.testing.assert_array_equal(got[0].numpy(), [4.0, 0.0, 4.0, 2.0, 0.0])
    none = tseg.segment_rowsum(T(rows), T(starts[:0]), T(ends[:0]))
    assert tuple(none.shape) == (2, 0)
    all_empty = tseg.segment_rowsum(T(rows), torch.zeros(6, dtype=torch.int32),
                                    torch.zeros(6, dtype=torch.int32))
    assert not all_empty.any()


def test_segment_rowsum_rejects_bad_input():
    rows, starts, ends = _segments(0, 20, 3)
    with pytest.raises(ValueError):
        tseg.segment_rowsum(T(rows), T(starts).to(torch.int64), T(ends))
    with pytest.raises(ValueError):
        tseg.segment_rowsum(T(rows), T(starts), T(ends)[:10])
    with pytest.raises(ValueError):
        tseg.segment_rowsum(T(rows)[0], T(starts), T(ends))
    with pytest.raises(ValueError):
        tseg.segment_rowsum(T(rows).double(), T(starts), T(ends))
