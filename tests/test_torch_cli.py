"""The port's entry points (street_gaussians_ns_tpu_torch.scripts.{train,
eval,render,export}) and the metrics they use (ops/lpips, ops/chamfer)
against the JAX package's, on the CPU, on tests/test_data.write_clip's
clip at tests/test_integration.py's small configs.

The JAX side is one module fixture: a JAX run directory (4 training
steps) evaluated, rendered and exported by the JAX CLIs; the port's CLIs
then read the same run directory with --device cpu. The run's config.json
names the JAX chunked route, whose per-tile budget (1,024) the vehicle's
tiles pass; the port renders through its fused route, which drops no
pair, so the JAX CLIs evaluate and render with a budget that truncates
nothing. Tolerances: PSNR
within 1e-3 dB, SSIM within 1e-5, LPIPS and the chamfer distances at
rtol 1e-4; rendered PNGs within 1 in uint8 (depth: within one entry of
the colormap); exported .ply files bit for bit."""
import functools
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.engine import trainer as jtrainer
from street_gaussians_ns_tpu.engine.trainer import Trainer as JTrainer
from street_gaussians_ns_tpu.ops import chamfer as jchamfer
from street_gaussians_ns_tpu.ops import lpips as jlpips
from street_gaussians_ns_tpu.scripts import eval as jeval
from street_gaussians_ns_tpu.scripts import export as jexport
from street_gaussians_ns_tpu.scripts import render as jrender
from street_gaussians_ns_tpu_torch.ops import chamfer as tchamfer
from street_gaussians_ns_tpu_torch.ops import lpips as tlpips
from street_gaussians_ns_tpu_torch.scripts import eval as teval
from street_gaussians_ns_tpu_torch.scripts import export as texport
from street_gaussians_ns_tpu_torch.scripts import render as trender
from street_gaussians_ns_tpu_torch.scripts import train as ttrain
from street_gaussians_ns_tpu_torch.scripts import viewer as tviewer

from test_data import write_clip
from test_integration import small_configs

REPO = Path(__file__).resolve().parents[1]
HEADS = ["rgb", "depth", "accumulation", "background_rgb", "object_rgb",
         "gt-rgb"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    clip = tmp_path_factory.mktemp("clip")
    write_clip(clip)
    run = tmp_path_factory.mktemp("jax_run")
    data, model, trainer, dm = small_configs(clip, run)
    trainer.max_num_iterations = 4
    trainer.steps_per_save = 4
    JTrainer(data, model, trainer, dm).train()
    lidar = str(clip / "aggregate_lidar/dynamic_objects/veh1.ply")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "RenderConfig", functools.partial(
            jtrainer.RenderConfig, max_per_tile=16384))
        jeval.main(["--load-dir", str(run), "--compute-chamfer",
                    "--aggregate-lidar", lidar])
        jrender.main(["--load-dir", str(run), "--output-path",
                      str(run / "jax_renders"), "--rendered-output-names",
                      *HEADS])
    jexport.main(["--load-dir", str(run), "--output-dir",
                  str(run / "jax_exports")])
    return dict(clip=clip, run=run, lidar=lidar,
                eval=json.loads((run / "eval_output.json").read_text()))


def test_eval_matches_jax(jax_run):
    run = jax_run["run"]
    out = teval.main(["--load-dir", str(run), "--compute-chamfer",
                      "--aggregate-lidar", jax_run["lidar"], "--device",
                      "cpu", "--output-path", str(run / "port_eval.json")])
    assert json.loads((run / "port_eval.json").read_text()) == out
    got, want = out["results"], jax_run["eval"]["results"]
    assert set(got) == set(want)
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    np.testing.assert_allclose(got["lpips"], want["lpips"], rtol=1e-4)
    for k in ("lidar_chamfer_distance_1", "lidar_chamfer_distance_2",
              "lidar_chamfer_distance_avg"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert {k: v for k, v in out.items() if k != "results"} == {
        k: v for k, v in jax_run["eval"].items() if k != "results"}
    assert np.isfinite(list(got.values())).all()


def _turbo_index(img):
    """The colormap entry of each pixel of a depth PNG."""
    import cv2

    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_TURBO)[:, 0, ::-1].astype(np.int32)
    d = np.abs(img.astype(np.int32)[..., None, :] - lut).sum(-1)
    return d.argmin(-1)


def test_render_matches_jax(jax_run):
    from PIL import Image

    run = jax_run["run"]
    trender.main(["--load-dir", str(run), "--output-path",
                  str(run / "port_renders"), "--rendered-output-names",
                  *HEADS, "--device", "cpu"])
    n = 0
    for head in HEADS:
        want_files = sorted((run / "jax_renders" / head).glob("*.png"))
        got_files = sorted((run / "port_renders" / head).glob("*.png"))
        assert [p.name for p in got_files] == [p.name for p in want_files]
        for g, w in zip(got_files, want_files):
            gi = np.asarray(Image.open(g))
            wi = np.asarray(Image.open(w))
            assert gi.shape == wi.shape == (48, 64, 3)
            if head == "depth":
                diff = np.abs(_turbo_index(gi) - _turbo_index(wi))
            else:
                diff = np.abs(gi.astype(np.int32) - wi.astype(np.int32))
            assert int(diff.max()) <= 1, (head, g.name)
            n += 1
    assert n == 3 * len(HEADS)


def test_render_helpers_match_jax(jax_run, tmp_path):
    """The depth colormap and the novel-view vehicle retarget."""
    from types import SimpleNamespace

    from street_gaussians_ns_tpu.data.datamanager import (
        DataManagerConfig as JDMConfig, FullImageDatamanager as JDM)
    from street_gaussians_ns_tpu.data.dataparser import (
        DataParserConfig as JDPConfig, parse_scene as jparse)
    from street_gaussians_ns_tpu_torch.data.datamanager import (
        DataManagerConfig as TDMConfig, FullImageDatamanager as TDM)
    from street_gaussians_ns_tpu_torch.data.dataparser import (
        DataParserConfig as TDPConfig, parse_scene as tparse)

    depth = np.random.RandomState(2).rand(48, 64) * 4.0
    np.testing.assert_array_equal(trender.apply_colormap(depth),
                                  jrender.apply_colormap(depth))
    delta = np.eye(4)[:3]
    delta[:, 3] = [0.5, -1.0, 2.0]
    vehicle = tmp_path / "nvs.json"
    vehicle.write_text(json.dumps({"cam1/": delta.tolist()}))
    clip, dm_kw = jax_run["clip"], dict(undistort=False, cache_workers=2)
    tscene = tparse(TDPConfig(data=clip), device="cpu")
    jscene = jparse(JDPConfig(data=clip))
    got = trender.transform_cameras_to_new_vehicle(SimpleNamespace(
        scene=tscene, dm=TDM(tscene, TDMConfig(**dm_kw), device="cpu")),
        vehicle)
    want = jrender.transform_cameras_to_new_vehicle(SimpleNamespace(
        scene=jscene, dm=JDM(jscene, JDMConfig(**dm_kw))), vehicle)
    np.testing.assert_array_equal(got.scene.c2w, want.scene.c2w)
    assert not np.array_equal(got.scene.c2w, tscene.c2w)
    for idx, frame in got.dm._cache.items():
        np.testing.assert_array_equal(frame.c2w, want.dm._cache[idx].c2w)


def test_export_matches_jax_bit_for_bit(jax_run):
    run = jax_run["run"]
    counts = texport.main(["--load-dir", str(run), "--output-dir",
                           str(run / "port_exports"), "--device", "cpu"])
    names = sorted(p.name for p in (run / "jax_exports").glob("*.ply"))
    assert names == ["point_cloud_background.ply",
                     "point_cloud_object_veh1.ply"]
    for name in names:
        assert (run / "port_exports" / name).read_bytes() == \
            (run / "jax_exports" / name).read_bytes(), name
    assert counts["object_veh1"] == 12000 and counts["background"] > 0


def test_lpips_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    a = rng.rand(48, 64, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(48, 64, 3), 0, 1).astype(np.float32)
    want = float(jlpips.random_lpips()(jnp.asarray(a), jnp.asarray(b)))
    got = float(tlpips.random_lpips(device="cpu")(torch.from_numpy(a),
                                                  torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want > 0
    # Weights in the .npz layout load_lpips reads (random, seeded).
    w = np.random.RandomState(5)
    arrays, in_ch = {}, 3
    for idx, ch in zip(tlpips._VGG_CONV_IDX, tlpips._VGG_CHANNELS):
        arrays[f"features.{idx}.weight"] = w.normal(
            0, np.sqrt(2.0 / (9 * in_ch)), (ch, in_ch, 3, 3)).astype(
            np.float32)
        arrays[f"features.{idx}.bias"] = w.normal(0, 0.01, ch).astype(
            np.float32)
        in_ch = ch
    for i, ch in enumerate((64, 128, 256, 512, 512)):
        arrays[f"lin{i}.model.1.weight"] = w.rand(1, ch, 1, 1).astype(
            np.float32)
    np.savez(tmp_path / "lpips.npz", **arrays)
    want = float(jlpips.load_lpips(tmp_path / "lpips.npz")(
        jnp.asarray(a), jnp.asarray(b)))
    got = float(tlpips.load_lpips(tmp_path / "lpips.npz", device="cpu")(
        torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_chamfer_matches_jax():
    rng = np.random.RandomState(1)
    a = rng.randn(500, 3).astype(np.float32)
    b = (rng.randn(700, 3) * 1.5 + 0.2).astype(np.float32)
    np.testing.assert_allclose(
        float(tchamfer.chamfer_distance(torch.from_numpy(a),
                                        torch.from_numpy(b))),
        float(jchamfer.chamfer_distance(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5)
    got = tchamfer._min_sqdist(torch.from_numpy(a), torch.from_numpy(b),
                               chunk=64)
    want = jchamfer._min_sqdist(jnp.asarray(a), jnp.asarray(b), chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    for g, w in zip(tchamfer.chamfer_directed(torch.from_numpy(a),
                                              torch.from_numpy(b)),
                    jchamfer.chamfer_directed(jnp.asarray(a),
                                              jnp.asarray(b))):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    np.testing.assert_array_equal(tchamfer.gl2cv_points(a),
                                  jchamfer.gl2cv_points(a))
    tm = np.eye(4)[:3] * 0.5
    kw = dict(applied_translation=np.array([0.1, -0.2, 0.3]), max_points=300)
    got = tchamfer.evaluate_lidar_geometric(a, b, tm, 2.0, device="cpu",
                                            **kw)
    want = jchamfer.evaluate_lidar_geometric(a, b, tm, 2.0, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


# One torch thread a process, as the in-process tests pin it.
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def _run(*args, timeout=240):
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_modules_run_on_a_clip(tmp_path):
    """python -m ...scripts.{train,eval,render,export} --device cpu on a
    clip: train 4 steps with a checkpoint at 2 and 4, then evaluate,
    render and export the run (the three at once)."""
    clip = tmp_path / "clip"
    clip.mkdir()
    write_clip(clip)
    run = tmp_path / "run"
    pkg = "street_gaussians_ns_tpu_torch.scripts"
    res = _run(f"{pkg}.train", "--data", str(clip), "--device", "cpu",
               "--train-split-fraction", "0.5",
               "--trainer.output-dir", str(run),
               "--trainer.max-num-iterations", "4",
               "--trainer.steps-per-save", "2",
               "--trainer.background-capacity", "256",
               "--trainer.object-capacity", "16384",
               "--trainer.max-pairs", "16384",
               "--model.base.sh-degree", "1", "--model.base.env-map-res",
               "16", "--model.background.sh-degree", "1",
               "--model.object-template.sh-degree", "1",
               "--no-dm.undistort", "--dm.cache-workers", "2")
    assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(p.name for p in (run / "checkpoints").glob("*.npz")) == [
        "step-000000002.ckpt.npz", "step-000000004.ckpt.npz"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", *args, "--load-dir", str(run), "--device",
         "cpu"], cwd=REPO, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for args in (
        (f"{pkg}.eval",),
        (f"{pkg}.render", "--output-path", str(run / "renders"),
         "--rendered-output-names", "rgb", "depth"),
        (f"{pkg}.export", "--output-dir", str(run / "exports")))]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    res = json.loads((run / "eval_output.json").read_text())["results"]
    assert np.isfinite([res["psnr"], res["ssim"], res["lpips"]]).all()
    assert len(list((run / "renders" / "rgb").glob("*.png"))) == 3
    assert len(list((run / "renders" / "depth").glob("*.png"))) == 3
    assert (run / "exports" / "point_cloud_object_veh1.ply").exists()


@pytest.mark.parametrize("cli", ["train", "eval", "render", "export",
                                 "viewer"])
def test_cli_without_a_card_raises(jax_run, tmp_path, monkeypatch, cli):
    """Without --device cpu the entry points ask for the card, and raise
    where there is none: no silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = str(jax_run["run"])
    argv = {"train": ["--data", str(jax_run["clip"]),
                      "--trainer.output-dir", str(tmp_path / "run")],
            "eval": ["--load-dir", run],
            "render": ["--load-dir", run, "--output-path", str(tmp_path)],
            "export": ["--load-dir", run, "--output-dir", str(tmp_path)],
            "viewer": ["--load-dir", run, "--port", "0"]}
    main = {"train": ttrain.main, "eval": teval.main,
            "render": trender.main, "export": texport.main,
            "viewer": tviewer.main}[cli]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv[cli])


def test_cli_mesh_trains_and_its_checkpoint_restores(tmp_path):
    """The mesh flags (they replaced the raise of the multi-device
    trainer): two `scripts.train --device cpu --mesh-model 2` processes
    on gloo train a clip 4 steps; rank 0's checkpoint holds the gathered
    state, and the JAX package's eval_setup and the single-device port's
    each restore it leaf for leaf."""
    from street_gaussians_ns_tpu.engine.setup import eval_setup as jsetup
    from street_gaussians_ns_tpu_torch.engine import checkpoints as tckpt
    from street_gaussians_ns_tpu_torch.engine.setup import (
        eval_setup as tsetup)
    from street_gaussians_ns_tpu_torch.parallel.mesh import free_port

    from test_torch_scene_graph import store_arrays

    clip = tmp_path / "clip"
    clip.mkdir()
    write_clip(clip)
    run = tmp_path / "run"
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "street_gaussians_ns_tpu_torch.scripts.train",
         "--data", str(clip), "--device", "cpu",
         "--train-split-fraction", "0.5", "--trainer.output-dir", str(run),
         "--trainer.max-num-iterations", "4",
         "--trainer.steps-per-save", "4",
         "--trainer.background-capacity", "256",
         "--trainer.object-capacity", "16384",
         "--trainer.max-pairs", "16384",
         "--model.base.sh-degree", "1", "--model.base.env-map-res", "16",
         "--model.background.sh-degree", "1",
         "--model.object-template.sh-degree", "1",
         "--no-dm.undistort", "--dm.cache-workers", "2",
         "--mesh-model", "2", "--num-processes", "2",
         "--process-id", str(i), "--coordinator", coordinator],
        cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=400)
        assert p.returncode == 0, err[-3000:]
    ckpts = sorted((run / "checkpoints").glob("*.npz"))
    assert [p.name for p in ckpts] == ["step-000000004.ckpt.npz"]
    assert (run / "rank1" / "metrics.jsonl").exists()
    with np.load(ckpts[0]) as data:
        saved = {k: data[k] for k in data.files}
    assert saved["store/background/params/means"].shape[0] == 256
    jstate = store_arrays(jsetup(run).state)
    tstate = tckpt.state_to_numpy(tsetup(run, device="cpu").state)
    for got in (jstate, tstate):
        for k, v in got.items():
            np.testing.assert_array_equal(v, saved[k], err_msg=k)
    assert set(tstate) <= set(jstate) <= set(saved)
    assert int(saved["step"]) == 4


def test_viewer_entry_point_serves_a_jax_run(jax_run, monkeypatch, capsys):
    """scripts.viewer.main on the JAX run directory, in this process, its
    servicing loop stopped once a client has fetched /, /init, /state and
    one frame: the initial camera is the JAX viewer's, /state reports the
    checkpoint's step, and the frame is the JPEG of the trainer's own
    viewer render of the request at the ladder's size."""
    from street_gaussians_ns_tpu.engine.setup import eval_setup as jsetup
    from street_gaussians_ns_tpu.engine.trainer import attach_viewer
    from street_gaussians_ns_tpu_torch.utils import viewer as tview

    got = {}

    def serve(server, render_fn, poll_s=0.02):
        def record(*args):
            got["rgb"] = render_fn(*args)
            return got["rgb"]

        def client():
            base = f"http://127.0.0.1:{server.port}"
            got["page"] = urllib.request.urlopen(base + "/", timeout=30).read()
            got["init"] = json.loads(urllib.request.urlopen(
                base + "/init", timeout=30).read())
            got["state"] = json.loads(urllib.request.urlopen(
                base + "/state", timeout=30).read())
            q = urllib.parse.urlencode({
                "c2w": ",".join(str(v) for v in got["init"]["c2w"]),
                "time": got["init"]["time"], "res": "low"})
            got["jpeg"] = urllib.request.urlopen(
                f"{base}/frame?{q}", timeout=300).read()

        th = threading.Thread(target=client)
        th.start()
        while th.is_alive():
            if not server.service(record):
                time.sleep(poll_s)
        th.join(timeout=10)
        assert not th.is_alive()

    monkeypatch.setattr(tview.ViewerServer, "serve_forever", serve)
    tviewer.main(["--load-dir", str(jax_run["run"]), "--device", "cpu",
                  "--port", "0"])
    assert "viewer: http://localhost:" in capsys.readouterr().out
    jserver = attach_viewer(jsetup(jax_run["run"]), 0)
    try:
        assert got["init"] == jserver._init
    finally:
        jserver.close()
    assert b"viewer" in got["page"]
    assert got["state"] == {"step": 4.0, "mode": "checkpoint"}
    Image = tview.pillow_image()
    img = np.asarray(Image.open(io.BytesIO(got["jpeg"])))
    assert img.shape == got["rgb"].shape == (*tview.RES_LADDER["low"][::-1],
                                             3)
    assert got["rgb"].std() > 5
    assert np.abs(img.astype(float) - got["rgb"]).mean() < 3.0
