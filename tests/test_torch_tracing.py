"""The port's spans and host-sync counts (utils/profiling.py).

On the CPU:
- Off (no profiler session, enable(False)), a trainer iteration, a
  scene-graph train step and an eval frame run with
  torch.profiler.record_function and torch.cuda.Event made to raise, and
  the registry stays empty.
- Under torch.profiler, Trainer.train over one refine step, a Splatfacto
  train_step and an eval forward_scene record every span of the loop, the
  step and the frame with its parent and count, the sync spans' counts
  among them; the Chrome trace nests the sgnt:: events in call order;
  trace(dir) writes spans.json beside trace.json.

On the card (marked cuda; skips without one): under
torch.cuda.set_sync_debug_mode("warn"), a trainer iteration (a plain
step, a capacity check, a refine), a Splatfacto step and an eval frame
make as many synchronising operations as the recorder counts syncs, so no
host wait of the hot path lies outside a sync=True span. This file
imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_tracing.py -q --noconftest \
        -o addopts="" -m cuda
"""
import dataclasses
import json
import sys
import warnings

import pytest
import torch

import chip_smoke as cs
from street_gaussians_ns_tpu_torch.data.datamanager import DataManagerConfig
from street_gaussians_ns_tpu_torch.data.dataparser import DataParserConfig
from street_gaussians_ns_tpu_torch.engine import train_step as ts
from street_gaussians_ns_tpu_torch.engine import trainer as tm
from street_gaussians_ns_tpu_torch.engine.checkpoints import (
    store_from_numpy, tracks_from_numpy)
from street_gaussians_ns_tpu_torch.engine.scene_train_step import (
    init_scene_train_state, scene_train_step)
from street_gaussians_ns_tpu_torch.models.scene_graph import (
    SceneGraphConfig, forward_scene)
from street_gaussians_ns_tpu_torch.models.splatfacto import SplatfactoConfig
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig
from street_gaussians_ns_tpu_torch.utils import profiling

SIZE = cs.Size(bg=600, objects=1, per_object=64, env_res=16, width=64,
               height=48, focal=48.0, frames=2)
# The trainer's clip: no vehicle (an object needs 10,000 LiDAR points to
# be kept, which makes a CPU step slow); the eval frame and the scene
# step above have one.
CLIP = cs.Clip(frames=3, points=3000, objects=0,
               size=cs.Size(width=64, height=48, focal=50.0))
REFINE_STEP = 100                # a refine and a capacity check follow it

R = "render.rasterize"
RENDER = {"render.project": None, R: None, "tiles.depth_sort": R,
          "tiles.row_trim": R, "tiles.bin_rest": R, "composite.pack": R,
          "composite.fwd": R, "render.read_counts": R, "render.pairs": R}
STEP = {"step.forward": None, "step.backward": None, "step.adam": None,
        "step.stats": None, "scene.sh": "step.forward",
        "scene.sky": "step.forward", "composite.bwd": "step.backward",
        "composite.visited": "composite.bwd",
        **{k: v or "step.forward" for k, v in RENDER.items()}}
COMPOSE = {"scene.compose": "step.forward", "scene.pose": "scene.compose"}
COUNTERS = {"render.pairs"}
SYNCS = {"render.read_counts", "composite.visited", "trainer.target_copy",
         "trainer.capacity_check", "trainer.log_scalars", "refine.nonzero"}


def _parents_and_counts(snap, parents, counts):
    assert set(snap) == set(parents)
    for name, row in snap.items():
        assert row["parent"] == parents[name], name
        assert row["count"] == counts.get(name, 1), name
        assert ("syncs" in row) == (name in SYNCS), name
        if name in SYNCS:
            assert row["syncs"] == row["count"]
            assert row["wait_ms"] == row["host_ms"] >= 0.0
        if name in COUNTERS:
            assert set(row) == {"count", "total", "parent"}, name
        else:
            assert row["device_ms"] is None     # no card


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _scene(dev):
    store_np, tracks_np = cs.make_scene(0, SIZE.bg, SIZE.objects,
                                        SIZE.per_object, SIZE.env_res)
    cfg = cs.scene_config(3, SIZE.env_res, 5)
    store = store_from_numpy(store_np, cfg, device=dev)
    tracks = tracks_from_numpy(tracks_np, device=dev)
    cams = cs.cameras(SIZE.frames, SIZE.width, SIZE.height, SIZE.focal, dev)
    mp, mr, _, _ = cs.size_capacity(store, tracks, cfg, cams)
    return store, tracks, cfg, RenderConfig(max_pairs=mp, max_rowruns=mr), \
        cams


def _splat(dev):
    cloud, env = cs.splat_arrays(1, SIZE.bg, SIZE.env_res)
    store = cs.gaussian_store(cloud, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = ts.init_train_state(store, torch.from_numpy(env).to(dev), gen)
    cams = cs.cameras(1, SIZE.width, SIZE.height, SIZE.focal, dev)
    mp, mr, _, _ = cs.splat_capacity(store, cams)
    return (dataclasses.replace(state, step=3600), cams[0],
            cs.splat_config(3, SIZE.env_res),
            RenderConfig(max_pairs=mp, max_rowruns=mr))


def _trainer(tmp_path, dev):
    clip = tmp_path / "clip"
    cs.write_clip(clip, 3, CLIP, "cpu")
    return tm.Trainer(
        DataParserConfig(data=clip),
        SceneGraphConfig(base=SplatfactoConfig(
            use_sky_sphere=True, sh_degree=3, env_map_res=16)),
        tm.TrainerConfig(output_dir=tmp_path / "run",
                         background_capacity=4096, object_capacity=256,
                         max_pairs=2 ** 16, steps_per_save=10 ** 6),
        DataManagerConfig(cache_workers=1), device=dev)


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """A CPU trainer on a tiny clip, the tiny scene graph and a Splatfacto
    state (the trainer without the TensorBoard mirror, whose import loads
    TensorFlow where it is installed)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        trainer = _trainer(tmp_path_factory.mktemp("tracing"), "cpu")
    return {"trainer": trainer, "scene": _scene("cpu"),
            "splat": _splat("cpu")}


def _eval_frame(scene, cam=0):
    store, tracks, cfg, rcfg, cams = scene
    with torch.no_grad():
        return forward_scene(store, tracks, cams[cam], 0, cfg, rcfg,
                             training=False, eval_extras=True)


def _scene_step(scene, batch):
    store, tracks, cfg, rcfg, cams = scene
    gen = torch.Generator(device=batch["image"].device)
    gen.manual_seed(0)
    state = dataclasses.replace(init_scene_train_state(store, gen),
                                step=3600)
    return scene_train_step(state, tracks, cams[0], batch, cfg, rcfg,
                            subset_accs=False)


def _splat_step(splat, batch):
    state, cam, cfg, rcfg = splat
    return ts.train_step(state, cam, batch, cfg, rcfg)


def _batch(dev):
    """A target image and semantic map on `dev` (made before a counted
    call: the copy to the card is the test's, not the program's)."""
    return cs.make_batch(0, SIZE.width, SIZE.height, dev)


def _profiled(fn):
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return profiling.snapshot(), prof


def test_spans_off_record_nothing(cpu_run, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span made a record_function or an event "
                             "while tracing is off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert profiling.span("x") is profiling.span("y", sync=True)
    cpu_run["trainer"]._iteration(REFINE_STEP)
    _scene_step(cpu_run["scene"], _batch("cpu"))
    _eval_frame(cpu_run["scene"])
    assert profiling.snapshot() == {}


def test_trainer_loop_spans(cpu_run):
    tr = cpu_run["trainer"]
    tr.start_step = REFINE_STEP
    snap, _ = _profiled(lambda: tr.train(REFINE_STEP + 1))
    loop = {"trainer.draw": None, "trainer.target_copy": None,
            "trainer.refine": None, "refine.nonzero": "trainer.refine",
            "trainer.capacity_check": None, "trainer.log_scalars": None,
            **COMPOSE}
    # image and semantic copied one after the other; the background's
    # refine finds free slots and valid children
    _parents_and_counts(snap, {**STEP, **loop},
                        {"trainer.target_copy": 2, "refine.nonzero": 2})
    assert sum(r.get("syncs", 0) for r in snap.values()) == 8


def test_scene_step_and_splatfacto_step_spans(cpu_run):
    batch = _batch("cpu")
    snap, _ = _profiled(lambda: _scene_step(cpu_run["scene"], batch))
    _parents_and_counts(snap, {**STEP, **COMPOSE}, {})
    snap, _ = _profiled(lambda: _splat_step(cpu_run["splat"], batch))
    _parents_and_counts(snap, STEP, {})
    assert sum(r.get("syncs", 0) for r in snap.values()) == 2


def test_eval_frame_spans_nest_in_the_chrome_trace(cpu_run, tmp_path):
    snap, prof = _profiled(lambda: _eval_frame(cpu_run["scene"]))
    parents = {"scene.compose": None, "scene.pose": "scene.compose",
               "scene.sh": None, "scene.sky": None, **RENDER}
    _parents_and_counts(snap, parents,
                        {k: 3 for k in RENDER})       # three renders
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                 if e.get("ph") == "X"
                 and e.get("name", "").startswith(profiling.PREFIX)),
                key=lambda e: (e["ts"], -e["dur"]))
    names = [e["name"][len(profiling.PREFIX):] for e in ev]
    assert names[:4] == ["scene.compose", "scene.pose", "scene.sh",
                         "scene.sky"]
    render = ["render.project", R, "tiles.depth_sort", "tiles.row_trim",
              "tiles.bin_rest", "composite.pack", "composite.fwd",
              "render.read_counts"]
    assert names[4:] == render * 3
    # Each event lies inside its parent's, the last one of that name
    # opened before it.
    for i, e in enumerate(ev):
        parent = parents[names[i]]
        if parent is None:
            continue
        p = next(q for q in reversed(ev[:i])
                 if q["name"] == profiling.PREFIX + parent)
        assert p["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= p["ts"] + p["dur"]


def test_trace_writes_spans_json(cpu_run, tmp_path):
    with profiling.trace(tmp_path / "t"):
        _eval_frame(cpu_run["scene"], cam=1)
    spans = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert spans["render.read_counts"]["syncs"] == 3
    assert spans["tiles.row_trim"]["parent"] == R
    names = {e.get("name") for e in json.loads(
        (tmp_path / "t" / "trace.json").read_text())["traceEvents"]}
    assert "sgnt::tiles.row_trim" in names


def test_pose_span_and_pairs_counter(cpu_run):
    """`scene.pose` records once a compose, inside it; the counter
    `render.pairs` adds the pair count each render read to the host: a
    scene step's one render gives the step's own num_pairs, an eval
    frame's three renders three counts."""
    batch = _batch("cpu")
    out = {}
    snap, _ = _profiled(lambda: out.update(
        step=_scene_step(cpu_run["scene"], batch)))
    metrics = out["step"][1]
    assert snap["scene.pose"]["count"] == snap["scene.compose"]["count"] == 1
    assert snap["render.pairs"] == {"count": 1, "parent": R,
                                    "total": int(metrics["num_pairs"])}
    snap, _ = _profiled(lambda: out.update(frame=_eval_frame(
        cpu_run["scene"])))
    full = int(out["frame"][1].bins.num_pairs)
    assert snap["scene.pose"]["count"] == 1
    assert snap["render.pairs"]["count"] == 3
    assert snap["render.pairs"]["total"] > full > 0


def test_counter_off_records_nothing():
    profiling.count("render.pairs", 7)
    assert profiling.snapshot() == {}
    profiling.enable(True)
    profiling.count("render.pairs", 7)
    profiling.count("render.pairs", 5)
    profiling.enable(False)
    profiling.count("render.pairs", 100)
    assert profiling.snapshot() == {
        "render.pairs": {"count": 2, "total": 12, "parent": None}}


def test_threads_share_the_registry_without_losing_a_span():
    """Spans from several threads at once (autograd's backward records
    on a thread of its own): every one counted, each parent its own
    thread's."""
    import os
    import threading
    n_threads, n_spans = 4 * (os.cpu_count() or 2), 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.enable(True)
    try:
        def work(i):
            for _ in range(n_spans):
                with profiling.span("outer"):
                    with profiling.span("inner", sync=True):
                        pass
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        profiling.enable(False)
    snap = profiling.snapshot()
    assert snap["outer"]["count"] == snap["inner"]["syncs"] \
        == n_threads * n_spans
    assert snap["inner"]["parent"] == "outer"
    assert snap["outer"]["parent"] is None


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _syncs_and_warnings(fn):
    """(the recorder's syncs, the synchronising-operation warnings of
    torch.cuda.set_sync_debug_mode) of one call of fn."""
    profiling.reset()
    profiling.enable(True)
    # Switched on outside the record: the first switch warns once itself.
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    profiling.enable(False)
    snap = profiling.snapshot()
    warned = [f"{w.filename}:{w.lineno}" for w in caught
              if "synchroniz" in str(w.message)]
    return sum(r.get("syncs", 0) for r in snap.values()), warned, snap


@pytest.mark.cuda
def test_every_host_wait_is_a_sync_span(cuda, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tr = _trainer(tmp_path, cuda)
    scene, splat = _scene(cuda), _splat(cuda)
    calls = {f"iteration {s}": (lambda s=s: tr._iteration(s))
             for s in (REFINE_STEP - 1, REFINE_STEP + 10, REFINE_STEP)}
    batch = _batch(cuda)
    calls["scene step"] = lambda: _scene_step(scene, batch)
    calls["splatfacto step"] = lambda: _splat_step(splat, batch)
    calls["eval frame"] = lambda: _eval_frame(scene)
    seen, where = {}, {}
    for name, fn in calls.items():
        fn()                                 # warm-up: first-call syncs
        torch.cuda.synchronize()
        syncs, warned, snap = _syncs_and_warnings(fn)
        seen[name], where[name] = (syncs, len(warned)), warned
        assert all(r["device_ms"] is not None for k, r in snap.items()
                   if k not in COUNTERS)
    print("syncs / synchronising operations:", seen)
    for name, (s, w) in seen.items():
        assert s == w, (name, s, where[name])
    assert seen["eval frame"] == (3, 3)
    assert seen["splatfacto step"] == (2, 2)


@pytest.mark.cuda
def test_pose_span_and_pairs_counter_on_the_card(cuda):
    """On the card: `scene.pose` records once a compose with its device
    time, `render.pairs` equals the count the step's render read, and a
    scene step still makes two host syncs (the counter adds none)."""
    scene, batch = _scene(cuda), _batch(cuda)
    _scene_step(scene, batch)                  # warm-up
    torch.cuda.synchronize()
    out = {}
    syncs, warned, snap = _syncs_and_warnings(
        lambda: out.update(step=_scene_step(scene, batch)))
    assert (syncs, len(warned)) == (2, 2), warned
    assert snap["scene.pose"]["count"] == snap["scene.compose"]["count"] == 1
    assert snap["scene.pose"]["parent"] == "scene.compose"
    assert snap["scene.pose"]["device_ms"] is not None
    assert snap["render.pairs"]["count"] == 1
    assert snap["render.pairs"]["total"] == int(out["step"][1]["num_pairs"])
