"""The PVG cell (pvg3_train_s3600) on the CPU at tiny sizes: it runs as
files and is correct, its traced run reports the new readers, the
planted faults fail its check, its three new readers give nothing on a
program without the recorder or without PVG, its clip and checkpoint
are the same for the same seed, and its reference imports neither JAX
nor the program."""
from __future__ import annotations

import hashlib
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import pvg3
from benchmark import run as R

CELL = "pvg3_train_s3600"
NEW = ("pvg.temporal_ms.train", "pvg.temporal_bwd_ms.train",
       "pvg.faded_m.train")
SEED = 12345678901


def shrink(cfg: dict, traffic: dict) -> None:
    """Three cameras of 64x48 over 6 frames, 2,048 slots; shorter lives,
    so that some slots fade."""
    cfg.update(background_capacity=2048, env_map_res=16, track_frames=6,
               seed_points=1500, dynamic_lifespan_s=[0.02, 0.05])
    traffic.update(width=64, height=48, focal=48.0, image_block=8)


def found(root=R.ROOT):
    spec = R.load_spec(root)
    f = R.find_cell(spec, CELL, root)
    shrink(f["config"], f["traffic"])
    return spec, f


def test_the_cell_runs_as_files_and_reports_its_metrics(tmp_path):
    """The cell's files copied beside the program run it: correct, the
    end-to-end metrics untraced, the new counter traced (no device time
    off the card); the live cloud reported at the window's ends."""
    shutil.copytree(R.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(R.ROOT / "BENCHMARK.json", tmp_path)
    spec, f = found(tmp_path)
    r0 = R.run(CELL, SEED, 0.5, False, device="cpu", spec=spec, found=f,
               root=tmp_path, log=lambda *a: None)
    assert r0["correct"], r0["checks"]
    assert set(r0["metrics"]) == {"train_steps_per_s", "peak_mem_gib",
                                  "setup_s"}
    d = r0["detail"]
    assert len({g // 6 for g in d["frames"]}) == 3
    assert d["live"][0] == 2048 * 3 // 4
    assert not d["left_out"]
    spec, f = found(tmp_path)
    r1 = R.run(CELL, SEED + 1, 0.5, True, device="cpu", spec=spec, found=f,
               root=tmp_path, trace_units=2, log=lambda *a: None)
    assert r1["correct"], r1["checks"]
    m = r1["metrics"]
    assert m["pvg.faded_m.train"]["value"] > 0
    assert m["render.pairs_m.train"]["value"] > 0
    assert "pvg.temporal_ms.train" not in m        # no card, no device time


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_the_faults_fail_the_check(fault):
    spec, f = found()
    r = R.run(CELL, 5, 0.3, False, device="cpu", spec=spec, found=f,
              log=lambda *a: None, fault=fault)
    assert not r["correct"]


def test_new_readers_find_nothing_without_the_recorder(monkeypatch):
    from street_gaussians_ns_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")
    for name in NEW:
        assert R.load_reader(name)({"kind": "train", "units": 2}) is None


def test_new_readers_without_the_spans_or_counter():
    """A snapshot without PVG's spans and counter (the parent's program,
    or another cell's) gives nothing either."""
    from street_gaussians_ns_tpu_torch.utils import profiling
    profiling.reset()
    for name in NEW:
        assert R.load_reader(name)({"kind": "train", "units": 2}) is None


def _digest(root: Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file() and p.suffix != ".npz":
            out[str(p.relative_to(root))] = hashlib.sha1(
                p.read_bytes()).hexdigest()
    return out


def test_clip_and_checkpoint_are_deterministic_in_the_seed(tmp_path):
    """Two drivers of one seed write the same clip and checkpoint; another
    seed writes other ones."""
    import concurrent.futures

    from benchmark.drivers import train_pvg3
    spec, f = found()
    outs = []
    for i, seed in enumerate((SEED, SEED, SEED + 1)):
        wd = tmp_path / str(i)
        drv = train_pvg3.Driver(f["config"], f["traffic"], seed, "cpu", wd)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            _, pending = drv._write_inputs(pool)
            for p in pending:
                p.result()
        ck = next((wd / "run" / "checkpoints").glob("*.npz"))
        with np.load(ck) as z:
            arrays = {k: z[k] for k in z.files}
        outs.append((_digest(wd / "clip"), arrays, drv.check_frames))
    (c0, a0, f0), (c1, a1, f1), (c2, a2, f2) = outs
    assert c0 == c1 and f0 == f1 and a0.keys() == a1.keys()
    for k in a0:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
    assert "store/background/params/tau" in a0
    assert not np.array_equal(a0["store/background/params/velocity"],
                              a2["store/background/params/velocity"])
    assert c0 != c2


def test_the_temporal_leaves_follow_the_configuration():
    cfg = R.find_cell(R.load_spec(), CELL)["config"]
    cfg.update(background_capacity=40000, env_map_res=4)
    sc = pvg3.make_scene(3, cfg, "cpu")
    act = sc["bg/active"]
    beta = torch.exp(sc["bg/s_beta"][act, 0])
    speed = torch.linalg.vector_norm(sc["bg/velocity"][act], dim=-1)
    static = beta >= 8.4 * (1 - 1e-6)
    assert 0.73 < float(static.float().mean()) < 0.77
    assert float(beta[~static].max()) <= 2.0 * (1 + 1e-6)
    assert float(speed[static].max()) <= 0.1 * (1 + 1e-6)
    assert float(speed[~static].max()) <= 10.0 * (1 + 1e-6)
    assert float(sc["bg/velocity"][act][~static][:, 1].abs().max()) == 0.0
    tau = sc["bg/tau"][act, 0]
    assert 0.0 <= float(tau.min()) and float(tau.max()) <= 8.4
    assert int(act.sum()) == 30000


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference import pvg\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'street_gaussians_ns_tpu', "
            "'street_gaussians_ns_tpu_torch')]\n"
            "assert not bad, bad\n"
            "print('ok')\n") % str(R.ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr
