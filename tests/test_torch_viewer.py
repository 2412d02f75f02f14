"""The port's live viewer (utils/viewer.py, engine/trainer.attach_viewer,
Trainer._viewer_render, scripts/viewer.py) and utils/profiling.py, on the
CPU.

- The HTTP surface and the single-slot hand-off, as the JAX package's
  tests/test_viewer.py holds its own.
- A Trainer with viewer_port=0 on a write_clip clip answers a frame
  request between two steps, on the training thread; its viewer frame is
  bit for bit the clamped uint8 of a direct forward_scene(training=False)
  of the same camera.
- python -m ...scripts.viewer --device cpu --port 0 on that run: the URL
  line, one frame, terminated.
- profiling: spans and their snapshot, and trace() writing a Chrome trace
  and the spans' snapshot.
"""
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu_torch.engine import trainer as ttrainer
from street_gaussians_ns_tpu_torch.models.scene_graph import forward_scene
from street_gaussians_ns_tpu_torch.utils import profiling
from street_gaussians_ns_tpu_torch.utils import viewer as tview
from street_gaussians_ns_tpu_torch.utils.viewer import (RES_LADDER,
                                                        ViewerServer)

from test_data import write_clip
from test_integration import small_configs

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(port, path, timeout=30):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=timeout)


def _frame_query(c2w, t, res="low"):
    return "/frame?" + urllib.parse.urlencode({
        "c2w": ",".join(str(float(v)) for v in np.asarray(c2w).reshape(-1)),
        "time": t, "res": res})


def _decode(jpeg: bytes) -> np.ndarray:
    return np.asarray(tview.pillow_image().open(io.BytesIO(jpeg)))


def test_viewer_roundtrip():
    server = ViewerServer(port=0, host="127.0.0.1")
    try:
        c2w = np.eye(3, 4, dtype=np.float32)
        server.set_init(c2w, 0.25, extras={"frames": 3})
        server.update_stats(step=7, loss=0.5)
        assert b"viewer" in _get(server.port, "/").read()
        init = json.loads(_get(server.port, "/init").read())
        assert init["time"] == 0.25 and init["frames"] == 3
        assert len(init["c2w"]) == 12
        assert json.loads(_get(server.port, "/state").read())["step"] == 7.0

        got = {}

        def client():
            q = "/frame?c2w=" + ",".join(["1"] * 12) + "&time=0.5&res=med"
            got["jpeg"] = _get(server.port, q).read()

        th = threading.Thread(target=client)
        th.start()
        seen = {}

        def render_fn(c2w_req, t, w, h):
            seen["args"] = (c2w_req.shape, t, w, h)
            seen["thread"] = threading.current_thread()
            return np.full((h, w, 3), 128, np.uint8)

        assert not server.service(render_fn)      # nothing parked yet ...
        for _ in range(1000):                     # ... until the client is
            if server.service(render_fn):
                break
            th.join(timeout=0.01)
        th.join(timeout=10)
        assert not th.is_alive()
        assert seen["args"] == ((3, 4), 0.5, *RES_LADDER["med"])
        assert seen["thread"] is threading.current_thread()
        assert got["jpeg"][:2] == b"\xff\xd8"
        assert _decode(got["jpeg"]).shape == (540, 960, 3)

        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.port, "/frame?c2w=bogus")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.port, "/nothing")
        assert e.value.code == 404
    finally:
        server.close()


def test_a_failed_render_is_reported_not_raised(monkeypatch):
    """A render that raises (here: Pillow missing, which utils.optional
    names) answers the request with a 503 and puts render_error in
    /state; the servicing thread goes on."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    server = ViewerServer(port=0, host="127.0.0.1")
    try:
        codes = []

        def client():
            try:
                _get(server.port, "/frame?c2w=" + ",".join(["0"] * 12))
            except urllib.error.HTTPError as e:
                codes.append(e.code)

        th = threading.Thread(target=client)
        th.start()
        for _ in range(1000):
            if server.service(lambda c, t, w, h: np.zeros((h, w, 3),
                                                          np.uint8)):
                break
            th.join(timeout=0.01)
        th.join(timeout=10)
        assert not th.is_alive() and codes == [503]
        state = json.loads(_get(server.port, "/state").read())
        assert "Pillow" in state["render_error"]
    finally:
        server.close()


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """A Trainer with viewer_port=0 on a write_clip clip (its vehicle cut
    to 1,024 gaussians); a client parks a frame request before training
    starts, and 3 steps run. The pair capacity covers the ladder's
    frames."""
    clip = tmp_path_factory.mktemp("clip")
    write_clip(clip)
    run = tmp_path_factory.mktemp("run")
    data, model, trainer, dm = small_configs(clip, run)
    trainer = dataclasses.replace(
        trainer, viewer_port=0, max_num_iterations=3, steps_per_save=3,
        steps_per_eval_image=100, object_capacity=1024, presize_pairs=False,
        max_pairs=2 ** 19)
    cfgs = (data, model, trainer, dm)
    tt = ttrainer.Trainer(*cfgs, device="cpu")
    served = []
    render = tt._viewer_render

    def recording(*args):
        served.append((tt.state.step, args))
        return render(*args)

    tt._viewer_render = recording
    i0 = int(tt.scene.train_indices[0])
    got = {}

    def client():
        q = _frame_query(tt.scene.c2w[i0], float(tt.scene.times[i0]))
        got["jpeg"] = _get(tt.viewer.port, q, timeout=300).read()
        got["state"] = json.loads(_get(tt.viewer.port, "/state").read())

    th = threading.Thread(target=client)
    th.start()
    try:
        for _ in range(3000):                  # the request is parked
            if tt.viewer._req_evt.is_set():
                break
            time.sleep(0.01)
        assert tt.viewer._req_evt.is_set()
        tt.train()
        th.join(timeout=60)
        assert not th.is_alive()
    finally:
        tt.viewer.close()
    return dict(trainer=tt, run=run, got=got, served=served, cfgs=cfgs,
                c2w=tt.scene.c2w[i0], t=float(tt.scene.times[i0]))


def test_trainer_serves_between_steps(live):
    tt, got, served = live["trainer"], live["got"], live["served"]
    assert len(served) == 1
    step, (c2w, t, w, h) = served[0]
    assert step == 1                          # after step 0, before step 1
    assert (w, h) == RES_LADDER["low"]
    np.testing.assert_array_equal(c2w, np.asarray(live["c2w"], np.float32))
    assert _decode(got["jpeg"]).shape == (h, w, 3)
    assert got["state"]["step"] == 0.0 and "render_error" not in got["state"]
    assert np.isfinite(got["state"]["loss"])
    assert tt.state.step == 3


def test_viewer_render_is_a_direct_forward_scene(live):
    tt = live["trainer"]
    w, h = RES_LADDER["low"]
    got = tt._viewer_render(live["c2w"], live["t"], w, h)
    camera = tt.viewer_camera(live["c2w"], live["t"], w, h)
    s = w / float(tt.scene.width[int(tt.scene.train_indices[0])])
    assert float(camera.fx) == pytest.approx(
        float(tt.scene.fx[int(tt.scene.train_indices[0])]) * s, rel=1e-6)
    with torch.no_grad():
        out, _, _ = forward_scene(tt.state.store, tt.tracks, camera,
                                  tt.state.step, tt.config,
                                  tt.render_config, training=False)
    want = (torch.clamp(out["rgb"], 0.0, 1.0) * 255).to(torch.uint8).numpy()
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    assert got.std() > 5


def test_viewer_cli_serves_a_frame(live):
    """python -m ...scripts.viewer --device cpu --port 0 on the live run:
    the URL line, one frame at the ladder's size, then terminated."""
    run = live["run"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "street_gaussians_ns_tpu_torch.scripts.viewer",
         "--load-dir", str(run), "--device", "cpu", "--port", "0"],
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        deadline = time.time() + 240
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.match(r"viewer: http://localhost:(\d+)/", line)
            if m:
                port = int(m.group(1))
                break
        assert port, proc.stderr.read()[-3000:] if proc.poll() else "no URL"
        state = json.loads(_get(port, "/state").read())
        assert state == {"step": 3.0, "mode": "checkpoint"}
        jpeg = _get(port, _frame_query(live["c2w"], live["t"]),
                    timeout=240).read()
        assert _decode(jpeg).shape == (*RES_LADDER["low"][::-1], 3)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    assert proc.returncode is not None


def test_profiling_stats_and_trace(tmp_path):
    """span / spanned / snapshot / reset, and trace() writing a Chrome
    trace with the spans in it and their snapshot beside it."""
    profiling.reset()

    @profiling.spanned("work")
    def work(n):
        with profiling.span("work.read", sync=True):
            return int(torch.arange(n).sum())

    assert work(10) == 45                  # tracing off: nothing recorded
    assert profiling.snapshot() == {}
    profiling.enable(True)
    try:
        for n in (10, 100):
            assert work(n) == n * (n - 1) // 2
        with profiling.span("other"):
            pass
    finally:
        profiling.enable(False)
    st = profiling.snapshot()
    assert set(st) == {"work", "work.read", "other"}
    assert st["work"]["count"] == 2 and st["other"]["count"] == 1
    assert st["work.read"]["parent"] == "work"
    assert st["work"]["parent"] is None
    assert st["work.read"]["syncs"] == 2 and "syncs" not in st["work"]
    assert 0 <= st["work.read"]["wait_ms"] <= st["work"]["host_ms"]
    assert st["other"]["device_ms"] is None          # no card
    profiling.reset()
    assert profiling.snapshot() == {}

    with profiling.trace(tmp_path / "trace") as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
        work(5)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"aten::mm", "sgnt::work", "sgnt::work.read"} <= names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert spans["work.read"]["syncs"] == 1 and spans["work"]["count"] == 1
