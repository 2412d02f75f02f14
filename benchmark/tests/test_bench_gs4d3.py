"""The 4DGS cell (gs4d3_train_s3600) on the CPU at tiny sizes: it runs as
files and is correct, its traced run reports the new counter, the
planted faults fail its check, its four new readers give nothing on a
program without the recorder or without 4DGS, its clip and checkpoint
are the same for the same seed, the field's draws follow the
configuration, and its reference imports neither JAX nor the program."""
from __future__ import annotations

import hashlib
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import deform4d3
from benchmark import run as R

CELL = "gs4d3_train_s3600"
NEW = ("deform4d.field_ms.train", "deform4d.decode_ms.train",
       "deform4d.field_bwd_ms.train", "deform4d.samples_m.train")
SEED = 12345678901


def shrink(cfg: dict, traffic: dict) -> None:
    """Three cameras of 64x48 over 6 frames, 2,048 slots, a field of 4
    channels over 8-cell planes."""
    cfg.update(background_capacity=2048, env_map_res=16, track_frames=6,
               seed_points=1500, plane_channels=4, plane_base_resolution=8,
               time_cells=4, net_width=16)
    traffic.update(width=64, height=48, focal=48.0, image_block=8)


def found(root=R.ROOT):
    spec = R.load_spec(root)
    f = R.find_cell(spec, CELL, root)
    shrink(f["config"], f["traffic"])
    return spec, f


def test_the_cell_runs_as_files_and_reports_its_metrics(tmp_path):
    """The cell's files copied beside the program run it: correct, the
    end-to-end metrics untraced, the samples counter traced (no device
    time off the card); the live cloud reported at the window's ends."""
    shutil.copytree(R.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(R.ROOT / "BENCHMARK.json", tmp_path)
    spec, f = found(tmp_path)
    r0 = R.run(CELL, SEED, 0.5, False, device="cpu", spec=spec, found=f,
               root=tmp_path, log=lambda *a: None)
    assert r0["correct"], r0["checks"]
    assert set(r0["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                 "decoder_gap"}
    assert set(r0["metrics"]) == {"train_steps_per_s", "peak_mem_gib",
                                  "setup_s"}
    d = r0["detail"]
    assert len({g // 6 for g in d["frames"]}) == 3
    assert d["live"][0] == 2048 * 3 // 4
    assert not d["left_out"]
    assert {"field/planes", "field/decoder"} <= set(d["first_grad"])
    spec, f = found(tmp_path)
    r1 = R.run(CELL, SEED + 1, 0.5, True, device="cpu", spec=spec, found=f,
               root=tmp_path, trace_units=2, log=lambda *a: None)
    assert r1["correct"], r1["checks"]
    m = r1["metrics"]
    assert m["deform4d.samples_m.train"]["value"] == 2048 * 18 / 1e6
    assert m["render.pairs_m.train"]["value"] > 0
    assert "deform4d.field_ms.train" not in m     # no card, no device time


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_the_faults_fail_the_check(fault):
    spec, f = found()
    r = R.run(CELL, 5, 0.3, False, device="cpu", spec=spec, found=f,
              log=lambda *a: None, fault=fault)
    assert not r["correct"]


def test_the_bf16_field_control_fails_the_check():
    """The reference's field in bfloat16 in the program's place comes out
    not correct; the detail splits the decoder's first gradient by
    tensor."""
    spec, f = found()
    r = R.run(CELL, 5, 0.3, False, device="cpu", spec=spec, found=f,
              log=lambda *a: None, control="bf16_field")
    assert not r["correct"]
    parts = r["detail"]["decoder_parts"]
    assert {"w0", "b0", "means.b2", "quats.w2"} <= set(parts)
    assert all(len(v) == 2 for v in parts.values())
    assert r["detail"]["decoder_leaf"] in parts
    assert r["checks"]["decoder_gap"]["value"] > r["checks"][
        "decoder_gap"]["limit"]


def test_an_unknown_control_is_refused():
    spec, f = found()
    with pytest.raises(ValueError, match="control"):
        R.run(CELL, 5, 0.3, False, device="cpu", spec=spec, found=f,
              log=lambda *a: None, control="fp8")


def test_new_readers_find_nothing_without_the_recorder(monkeypatch):
    from street_gaussians_ns_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")
    for name in NEW:
        assert R.load_reader(name)({"kind": "train", "units": 2}) is None


def test_new_readers_without_the_spans_or_counter():
    """A snapshot without 4DGS's spans and counter (the parent's program,
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

    from benchmark.drivers import train_deform4d3
    spec, f = found()
    outs = []
    for i, seed in enumerate((SEED, SEED, SEED + 1)):
        wd = tmp_path / str(i)
        drv = train_deform4d3.Driver(f["config"], f["traffic"], seed, "cpu",
                                     wd)
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
    assert {"store/field/planes", "opt/field_decoder/mu"} <= set(a0)
    assert not np.array_equal(a0["store/field/planes"],
                              a2["store/field/planes"])
    assert c0 != c2


def test_the_field_follows_the_configuration():
    """The planes' draws (spatial uniform over 0.1-0.5, time 1 + N(0,
    0.05^2)), the decoder's sizes, the box and the time span, at the
    configuration's own widths."""
    from benchmark.reference import deform4d as ref
    cfg = R.find_cell(R.load_spec(), CELL)["config"]
    cfg.update(background_capacity=4000, env_map_res=4)
    sc = deform4d3.make_scene(3, cfg, "cpu")
    shapes = ref.plane_shapes(cfg)
    assert len(shapes) == 18
    assert sum(int(np.prod(s)) for s in shapes) == 10_106_880
    assert sc["field/planes"].numel() == 10_106_880
    assert sc["field/decoder"].numel() == 19_338
    off = 0
    for i, s in enumerate(shapes):
        p = sc["field/planes"][off:off + int(np.prod(s))]
        off += int(np.prod(s))
        if i % 6 < 3:
            assert 0.1 <= float(p.min()) and float(p.max()) <= 0.5
        else:
            assert abs(float(p.mean()) - 1.0) < 5e-3
            assert abs(float(p.std()) - 0.05) < 5e-3
    live = sc["bg/means"][sc["bg/active"]]
    assert torch.equal(sc["field/aabb"][0], live.amin(0))
    assert torch.equal(sc["field/aabb"][1], live.amax(0))
    assert sc["field/time_span"].tolist() == pytest.approx([0.0, 8.4])
    assert int(sc["bg/active"].sum()) == 3000


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference import deform4d\n"
            "from benchmark import deform4d3\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'street_gaussians_ns_tpu', "
            "'street_gaussians_ns_tpu_torch')]\n"
            "assert not bad, bad\n"
            "print('ok')\n") % str(R.ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr
