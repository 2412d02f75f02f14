"""The benchmark's four-card cell, sg_train_mesh4, on four gloo ranks on
the CPU at tiny sizes (benchmark/tests/tiny.py): its driver
(benchmark/drivers/train_mesh4.py) starts ranks 1-3 itself, every rank
trains through parallel.trainer.ShardedTrainer on a (4, 1) mesh, and the
reference (benchmark/reference/train_rows.py) follows the same steps,
each step's loss the mean over its four images. The check comes out
correct on a sound run and not correct under each fault and the bf16
control; the ranks load no JAX. No JAX here.
"""
import pytest

from torch_ranks import run_bench_cell

CELL = "sg_train_mesh4"
SEED = 12345678901          # above 2**32: the run takes large seeds


def test_the_cell_runs_on_four_ranks_and_is_correct():
    out = run_bench_cell(CELL, SEED)
    r = out["result"]
    assert out["forbidden"] == []
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_steps_per_s", "peak_mem_gib",
                                 "setup_s"}
    assert r["device"]["count"] == 4
    d = r["detail"]
    assert len(d["frames"]) == 3 * 4          # four images a step
    assert len(d["peaks_gib"]) == 4
    assert not d["left_out"]


def test_a_traced_run_reads_the_shared_layers():
    r = run_bench_cell(CELL, SEED + 1, trace=True)["result"]
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["program.host_syncs.train"]["value"] > 0
    assert m["trainer.build_stores_s"]["value"] > 0
    # No card, so no device time: the span's reader finds nothing.
    assert "parallel.grad_reduce_ms.train" not in m


@pytest.mark.parametrize("fault,control", [("unchanged", None),
                                           ("half_batch", None),
                                           (None, "bf16")])
def test_faults_and_the_control_fail_the_check(fault, control):
    r = run_bench_cell(CELL, 5, seconds=0.3, fault=fault,
                       control=control)["result"]
    assert not r["correct"], r["checks"]
