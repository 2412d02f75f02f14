"""The port's row scans (ops/scan.cumsum_rows, cummax_rows, kernel H)
against the JAX package on the same numpy inputs, on the CPU, where the
wrappers run their plain PyTorch versions.

int32 results are exact (sums wrap in both packages). float32 sums are
taken in another order than jnp.cumsum's, so they are held at rtol 1e-5
of the column's largest running magnitude."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.ops import scan_pallas as jscan
from street_gaussians_ns_tpu_torch.ops import scan as tscan


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


def _ints(seed, m, c):
    rng = np.random.default_rng(seed)
    x = rng.integers(-50, 1000, size=(m, c)).astype(np.int32)
    # Long flat stretches, as an owner-mark array has them.
    x[rng.random((m, c)) < 0.7] = -1
    return x


# M is no multiple of either package's block (2048 rows there; 256 threads
# x 32 // C rows here).
@pytest.mark.parametrize("c", [1, 6, 8, 16])
@pytest.mark.parametrize("op", ["add", "max"])
def test_int32_row_scans_match_jax_exactly(c, op):
    x = _ints(c, 5000 + 37 * c, c)
    if op == "add":
        got, want = tscan.cumsum_rows(T(x)), jscan.cumsum_rows(jnp.asarray(x))
    else:
        got, want = tscan.cummax_rows(T(x)), jscan.cummax_rows(jnp.asarray(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("c", [1, 6, 16])
def test_float32_row_scans_match_jax(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((4100, c)).astype(np.float32)
    got = tscan.cumsum_rows(T(x)).numpy()
    want = np.asarray(jscan.cumsum_rows(jnp.asarray(x)))
    top = np.abs(want).max(axis=0, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * top).all()
    np.testing.assert_array_equal(
        tscan.cummax_rows(T(x)).numpy(),
        np.asarray(jscan.cummax_rows(jnp.asarray(x))))


def test_row_scans_match_pallas_interpret():
    x = _ints(0, 4100, 6)
    np.testing.assert_array_equal(
        tscan.cumsum_rows(T(x)).numpy(),
        np.asarray(jscan.cumsum_rows(jnp.asarray(x), interpret=True)))
    np.testing.assert_array_equal(
        tscan.cummax_rows(T(x)).numpy(),
        np.asarray(jscan.cummax_rows(jnp.asarray(x), interpret=True)))


def test_int32_sum_wraps():
    x = np.full((4, 2), 2 ** 30, np.int32)
    got = tscan.cumsum_rows(T(x)).numpy()
    np.testing.assert_array_equal(got, np.cumsum(x, axis=0, dtype=np.int32))
    assert got[-1, 0] == 0 and got[1, 0] < 0


def test_row_scan_scratch_and_bad_input():
    # One level of block totals per 256 * (32 // C) rows, then the totals'.
    assert tscan._rows_scratch_len(100, 6) == 1
    assert tscan._rows_scratch_len(1281, 6) == 2 * 6
    assert tscan._rows_scratch_len(4_456_448, 16) == (8704 + 17) * 16
    assert tuple(tscan.cumsum_rows(torch.zeros((0, 3),
                                               dtype=torch.int32)).shape) \
        == (0, 3)
    with pytest.raises(ValueError):
        tscan.cumsum_rows(torch.zeros((4, 17), dtype=torch.int32))
    with pytest.raises(ValueError):
        tscan.cummax_rows(torch.zeros((4,), dtype=torch.int32))
    with pytest.raises(TypeError):
        tscan.cumsum_rows(torch.zeros((4, 2), dtype=torch.int64))
