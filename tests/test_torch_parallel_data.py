"""The port's sharded step (parallel/sharded.py) on meshes with two data
rows, (2, 1) and (2, 2), in gloo processes on the CPU (tests/
torch_ranks.py), against the JAX package's sharded step on conftest's virtual
CPU devices (impl="pallas" in interpret mode, as tests/test_sharded.py
runs it), from the same state, batches and sky jitters.

Each data row trains on its own camera; the loss and PSNR are the means
over the rows and the gradients their sums (the (2, 2) mesh sums the
background shard's over the rows and the replicated leaves' over every
rank), the radii are maxed over the rows for the statistics, and the
pair counts maxed over every rank.

Tolerances as tests/test_torch_parallel.py states them."""
import pytest

from test_torch_parallel import assert_same_step, jax_sharded, port_sharded


@pytest.mark.parametrize("model", [1, 2])
def test_data_mesh_matches_jax(model, tmp_path):
    want = jax_sharded(2, model)
    got = port_sharded(want, tmp_path)
    assert_same_step(got, want)
    rows = {r["row"] for r in got["ranks"]}
    assert rows == {0, 1}
    # The rows trained on different cameras: their pair counts differ, and
    # the metric is the max over every rank.
    local = [r["metrics"][0]["num_pairs_local"] for r in got["ranks"]]
    assert max(local) == got["metrics"]["num_pairs"]
