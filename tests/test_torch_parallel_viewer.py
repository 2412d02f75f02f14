"""The live viewer of a multi-process ShardedTrainer (parallel/trainer.py:
`_service_viewer`, `gather_store`) on the CPU. Two gloo ranks
(tests/torch_ranks.run_viewer_ranks) train a tests/test_data.write_clip
clip with viewer_port=0 while a client in this process asks for frames;
rank 0 waits before each hand-off until the client's next request is
parked, so each request is answered at a step of its own.

- (1, 2) and (2, 1): every answered frame equals, bit for bit, the
  single-device Trainer._viewer_render of gather_state taken at the same
  hand-off; the JPEGs come back at the ladder's sizes.
- (1, 2) against the JAX package's ShardedTrainer._viewer_render on two of
  conftest's virtual CPU devices, from one state (the JAX arrays carried
  to the port by engine/checkpoints.train_state_from_numpy): the float rgb
  at atol 2e-5 (tests/test_torch_scene_graph.py's render tolerance); the
  uint8 frames at most one level apart, and only where the float lies
  within 2e-5 of a rounding step.
- Rank 1 binds no port and logs no URL; a render that raises on rank 0 is
  answered 503 and named in /state while both ranks train on.
- A request parked during the last step is answered and both ranks exit,
  inside run_ranks' time limit; one parked after the last hand-off gets
  the viewer's timeout.
- With viewer_port unset, or in a world of one process, the hand-off
  makes no collective call."""
import dataclasses
import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.core.cameras import Camera as JCamera
from street_gaussians_ns_tpu.data.dataparser import (
    DataParserConfig as JDataParserConfig, parse_scene as jparse_scene)
from street_gaussians_ns_tpu.engine.scene_train_step import (
    init_scene_train_state as j_init_state)
from street_gaussians_ns_tpu.ops.render import RenderConfig as JRenderConfig
from street_gaussians_ns_tpu.parallel.mesh import make_mesh as j_make_mesh
from street_gaussians_ns_tpu.parallel.trainer import (
    ShardedTrainer as JShardedTrainer, place_state as j_place_state)
from street_gaussians_ns_tpu_torch.engine.trainer import TrainerConfig
from street_gaussians_ns_tpu_torch.ops.render import RenderConfig
from street_gaussians_ns_tpu_torch.parallel import collectives, mesh as tmesh
from street_gaussians_ns_tpu_torch.parallel import trainer as ptrainer
from street_gaussians_ns_tpu_torch.utils.viewer import RES_LADDER

from test_data import write_clip
from test_integration import small_configs
from test_scene_graph import CFG, make_store, make_tracks
from test_torch_scene_graph import port_config, store_arrays
from torch_ranks import run_viewer_ranks

RANKS_TIMEOUT = 600          # s: the per-run limit on both ranks
FLOAT_ATOL = 2e-5
FAIL_TIME = 0.125            # a request at this time raises in the render


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    write_clip(root)
    return root


def _configs(clip, out, steps):
    """The CLI test's small configs with the viewer on: its vehicle cut to
    1,024 gaussians, a pair capacity that covers the 480x270 ladder frame
    (tests/test_torch_viewer.py's live trainer), and a background capacity
    of 64 for the clip's 50 seeds, so that both shards of a (1, 2) mesh
    hold active gaussians."""
    data, model, trainer, dm = small_configs(clip, out)
    trainer = dataclasses.replace(
        trainer, viewer_port=0, max_num_iterations=steps,
        steps_per_save=steps, steps_per_eval_image=10 ** 6,
        background_capacity=64, object_capacity=1024, presize_pairs=False,
        max_pairs=2 ** 19, render_impl="pallas")
    return data, model, trainer, dm


def _job(clip, out, mesh, steps, **viewer):
    return dict(backend="gloo", device="cpu", viewer=dict(
        configs=_configs(clip, out, steps), mesh=mesh, steps=steps,
        **viewer))


def _poses(clip, n):
    """n requests' (c2w, time) along the clip's train cameras, as the
    trainer's parser places them."""
    from street_gaussians_ns_tpu_torch.data.dataparser import parse_scene

    data = small_configs(clip, clip / "unused")[0]
    scene = parse_scene(data, device="cpu")
    idx = [int(i) for i in scene.train_indices]
    return [(np.asarray(scene.c2w[idx[k % len(idx)]], np.float32),
             float(scene.times[idx[k % len(idx)]])) for k in range(n)]


def _decode(jpeg: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(jpeg)))


def _run(clip, tmp, mesh, steps, requests, final=None, **viewer):
    return run_viewer_ranks(
        _job(clip, tmp / "run", mesh, steps, reference=True,
             final_request=final is not None, **viewer),
        mesh[0] * mesh[1], tmp / "ranks", requests, final,
        timeout=RANKS_TIMEOUT)


@pytest.fixture(scope="module")
def mesh12(clip, tmp_path_factory):
    """The (1, 2) run: 10 steps; four requests (480x270, one that raises,
    480x270, 960x540) answered at steps of their own, then one parked
    during the last step."""
    p = _poses(clip, 4)
    requests = [(*p[0], "low"), (p[1][0], FAIL_TIME, "low"),
                (*p[2], "low"), (*p[3], "med")]
    final = (*p[1], "low")
    ranks, got = _run(clip, tmp_path_factory.mktemp("mesh12"), (1, 2), 10,
                      requests, final, fail_time=FAIL_TIME)
    return dict(ranks=ranks, got=got, requests=requests, final=final,
                steps=10)


def _check_frames(run):
    """Every answered request: a JPEG of the ladder's size whose render is
    the single-device Trainer._viewer_render of gather_state, bit for
    bit, one answered frame a hand-off."""
    r0, got = run["ranks"][0], run["got"]
    answered = [(req, a) for req, a in zip(run["requests"], got["answers"])
                if a[0] == 200]
    if run.get("final") is not None:
        answered.append((run["final"], got["final"]))
    frames = r0["frames"]
    assert len(frames) == len(answered) >= 2
    for frame, ((c2w, t, res), (code, jpeg, _, *_)) in zip(frames,
                                                           answered):
        w, h = RES_LADDER[res]
        assert (frame["width"], frame["height"], frame["time"]) == (w, h, t)
        np.testing.assert_array_equal(frame["c2w"], c2w)
        assert _decode(jpeg).shape == (h, w, 3)
        assert frame["rgb8"].shape == (h, w, 3)
        np.testing.assert_array_equal(frame["rgb8"], frame["reference"])
        assert frame["rgb8"].std() > 1.0
    steps = [f["step"] for f in frames]
    assert len(set(steps)) == len(steps)
    assert all(1 <= s <= run["steps"] for s in steps)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_frames_equal_the_single_device_render(mesh, request, clip,
                                               tmp_path):
    """(1, 2): the store is gathered over the model group; (2, 1): each
    rank holds it whole and the gather is the identity."""
    if mesh == (1, 2):
        run = request.getfixturevalue("mesh12")
    else:
        p = _poses(clip, 2)
        requests = [(*p[0], "low"), (*p[1], "med")]
        ranks, got = _run(clip, tmp_path, mesh, 6, requests)
        run = dict(ranks=ranks, got=got, requests=requests, steps=6)
    _check_frames(run)
    r0 = run["ranks"][0]
    assert [rk["step"] for rk in run["ranks"]] == [run["steps"]] * 2
    # The ranks of row 0 gather at every answered request (the one that
    # raises too); rank 1 is in row 1 of the (2, 1) mesh and gathers none.
    served = len(r0["frames"]) + (mesh == (1, 2))
    assert len(r0["gather_ms"]) == served
    assert len(run["ranks"][1]["gather_ms"]) == (served if mesh == (1, 2)
                                                 else 0)


def test_rank_one_binds_no_port_and_a_failed_render_is_a_503(mesh12):
    """Only rank 0 starts a ViewerServer and logs the URL; the request
    whose render raises is answered 503 with render_error in /state, and
    the next requests and both ranks' steps go on."""
    r0, r1 = mesh12["ranks"]
    assert r0["servers"] == [0] and r1["servers"] == []
    assert r0["port"] == mesh12["got"]["port"] and r1["port"] is None
    assert "viewer: http://localhost:" in r0["stdout"]
    assert "viewer:" not in r1["stdout"]
    codes = [a[0] for a in mesh12["got"]["answers"]]
    assert codes == [200, 503, 200, 200]
    failed, after = mesh12["got"]["answers"][1:3]
    assert "RuntimeError" in failed[3]["render_error"]
    assert after[1][:2] == b"\xff\xd8"
    assert r0["step"] == r1["step"] == mesh12["steps"]
    # Every rank ran one hand-off a step; rank 1 joined each gather.
    assert [len(rk["handoffs"]) for rk in (r0, r1)] == [mesh12["steps"]] * 2
    served = [[s for _, s, _ in rk["handoffs"]] for rk in (r0, r1)]
    assert served[0] == served[1] and sum(served[0]) == 5
    assert len(r1["gather_ms"]) == 5


def test_a_request_on_the_last_step_ends_both_ranks(mesh12):
    """The request parked during the last step is answered after it, by
    the last hand-off; both ranks then exit 0 (run_ranks raises
    otherwise, and kills them after RANKS_TIMEOUT s). A request parked
    after the last hand-off is never taken: its wait runs out (1 s here)
    and it is answered None, a 503 to an HTTP client."""
    r0 = mesh12["ranks"][0]
    code, jpeg, _ = mesh12["got"]["final"]
    assert code == 200
    assert _decode(jpeg).shape == (*RES_LADDER["low"][::-1], 3)
    assert r0["frames"][-1]["step"] == mesh12["steps"]
    assert r0["handoffs"][-1][1] is True
    assert r0["late_request"] is None and r0["late_request_s"] >= 1.0


def test_mesh_frame_matches_the_jax_sharded_viewer(clip, tmp_path):
    """The port's (1, 2) frame against the JAX ShardedTrainer's
    _viewer_render on a (1, 2) mesh of two virtual CPU devices
    (impl="pallas" in interpret mode, the JAX trainer's default route off
    a TPU), from one state: test_scene_graph's store at step 39."""
    store = make_store(0)
    # The 128 random gaussians fill slots 0-127 of 256: rolled by 64, each
    # shard of the (1, 2) mesh holds 64 of them.
    store = dataclasses.replace(store, background=jax.tree.map(
        lambda x: jnp.roll(x, 64, axis=0), store.background))
    jstate = dataclasses.replace(j_init_state(store, jax.random.PRNGKey(0)),
                                 step=jnp.int32(39))
    active = np.asarray(jstate.store.background.active)
    assert active[:128].sum() == active[128:].sum() == 64
    tracks = make_tracks()
    c2w, t = np.eye(3, 4, dtype=np.float32), 1.0
    w, h = RES_LADDER["low"]
    data = small_configs(clip, tmp_path / "unused")[0]
    scene = jparse_scene(JDataParserConfig(
        data=clip, load_dynamic_annotations=True,
        train_split_fraction=data.train_split_fraction))
    mesh = j_make_mesh(data=1, model=2)
    jtrainer = types.SimpleNamespace(
        scene=scene, state=j_place_state(jstate, mesh), tracks=tracks,
        config=CFG, _step_fns={}, render_config=JRenderConfig(
            max_pairs=2 ** 18, impl="pallas", interpret=True))
    with jax.set_mesh(mesh):
        want8 = JShardedTrainer._viewer_render(jtrainer, c2w, t, w, h)
        i0 = int(scene.train_indices[0])
        sx, sy = w / float(scene.width[i0]), h / float(scene.height[i0])
        cam = JCamera.make(scene.fx[i0] * sx, scene.fy[i0] * sy,
                           scene.cx[i0] * sx, scene.cy[i0] * sy, c2w, w, h,
                           time=t)
        out, _, _ = jtrainer._step_fns[("viewer", h, w)](
            jtrainer.state.store, tracks, cam, jtrainer.state.step)
        want = np.asarray(jnp.clip(out["rgb"], 0.0, 1.0))
    assert jtrainer.state.store.background.params.means.sharding.spec[0] \
        == "model"

    swap = dict(state=store_arrays(jstate), tracks=store_arrays(tracks),
                config=port_config(CFG), seed=0,
                render_config=RenderConfig(max_pairs=2 ** 18))
    ranks, got = run_viewer_ranks(
        _job(clip, tmp_path / "run", (1, 2), 0, handoffs=1, reference=True,
             swap=swap),
        2, tmp_path / "ranks", [(c2w, t, "low")], timeout=RANKS_TIMEOUT)
    assert got["answers"][0][0] == 200
    (frame,) = ranks[0]["frames"]
    np.testing.assert_array_equal(frame["rgb8"], frame["reference"])
    np.testing.assert_allclose(frame["rgb"], want, rtol=0, atol=FLOAT_ATOL)
    diff = np.abs(frame["rgb8"].astype(np.int16) - want8.astype(np.int16))
    assert diff.max() <= 1
    v = want[diff > 0] * 255.0
    assert np.all(np.abs(v - np.round(v)) <= FLOAT_ATOL * 255.0)
    assert want8.std() > 1.0 and frame["rgb8"].std() > 1.0


def test_hand_off_makes_no_call_when_off_or_alone(monkeypatch):
    """With viewer_port unset the sharded hand-off returns before any
    collective; in a world of one process with the viewer on and nothing
    parked it broadcasts nothing either (collectives.broadcast)."""
    import torch.distributed as dist

    def no_call(*a, **kw):
        raise AssertionError("a collective call")

    monkeypatch.setattr(dist, "broadcast", no_call)
    monkeypatch.setattr(ptrainer, "gather_store", no_call)
    off = types.SimpleNamespace(tc=TrainerConfig(), viewer=None)
    assert ptrainer.ShardedTrainer._service_viewer(off) is False
    tmesh.multihost_init(backend="gloo")
    try:
        m = tmesh.make_mesh(device="cpu")
        alone = types.SimpleNamespace(tc=TrainerConfig(viewer_port=0),
                                      viewer=None, mesh=m)
        assert ptrainer.ShardedTrainer._service_viewer(alone) is False
        msg = ptrainer.viewer_message(None)
        assert collectives.broadcast(msg) is msg
    finally:
        dist.destroy_process_group()
    req = {"c2w": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
           "time": 0.1, "width": 480, "height": 270}
    msg = ptrainer.viewer_message(req).numpy()
    assert msg.dtype == np.float64 and msg.shape == (16,)
    assert msg[0] == 1 and msg[13] == 0.1 and tuple(msg[14:]) == (480, 270)
    np.testing.assert_array_equal(msg[1:13].astype(np.float32),
                                  req["c2w"].reshape(-1))
