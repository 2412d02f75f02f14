"""The port's per-group Adam (engine/optimizers.py) against the JAX
package's on identical gradients, on the CPU.

Tolerances: the schedule at rtol 1e-6; the step of one Adam update from
zero moments at 1e-6 of lr (with eps 1e-15 the first step is lr sign(g) in
both); the steps after it at 2e-5 of lr, because the bias corrections 1 - b^count are
differences of nearly equal float32 numbers and the two packages' float32
pow may differ in the last bit (one ulp of 0.999^3 is 2e-5 of 1 - 0.999^3).
Moments are held at rtol 1e-6 throughout."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_ns_tpu.engine import optimizers as jopt
from street_gaussians_ns_tpu_torch.engine import optimizers as topt
from street_gaussians_ns_tpu_torch.engine.train_step import GAUSSIAN_GROUPS


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


def test_default_groups_and_schedule_match_jax():
    assert set(topt.DEFAULT_GROUPS) == set(jopt.DEFAULT_GROUPS)
    assert len(topt.DEFAULT_GROUPS) == 9
    assert set(GAUSSIAN_GROUPS) <= set(topt.DEFAULT_GROUPS)
    for name, jc in jopt.DEFAULT_GROUPS.items():
        tc = topt.DEFAULT_GROUPS[name]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
        for step in (0, 1, 999, 35000, 70000, 90000):
            np.testing.assert_allclose(
                topt.schedule(tc, step),
                float(jopt.schedule(jc, jnp.int32(step))), rtol=1e-6,
                err_msg=f"{name} at {step}")
    assert topt.schedule(topt.DEFAULT_GROUPS["means"], 70000) == \
        pytest.approx(1.6e-6, rel=1e-5)


def _trees(seed, n=40):
    rng = np.random.default_rng(seed)
    shapes = {"bg": (n, 3), "obj": (2, n // 2, 3)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    gs = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1, s)
               ).astype(np.float32) for k, s in shapes.items()}
          for _ in range(4)]
    return p, gs


def _assert_tree_close(got, want, rtol, msg):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, atol=0, err_msg=f"{msg}/{k}")


@pytest.mark.parametrize("name", ["means", "opacities"])
def test_adam_update_matches_jax(name):
    cfg_j, cfg_t = jopt.DEFAULT_GROUPS[name], topt.DEFAULT_GROUPS[name]
    p0, gs = _trees(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: T(v) for k, v in p0.items()}
    js, ts = jopt.init_adam(jp), topt.init_adam(tp)
    for i, g in enumerate(gs):
        step = 100 * i
        jp, js = jopt.adam_update({k: jnp.asarray(v) for k, v in g.items()},
                                  js, jp, jopt.schedule(cfg_j,
                                                        jnp.int32(step)),
                                  cfg_j)
        tp_old = tp
        tp, ts = topt.adam_update({k: T(v) for k, v in g.items()}, ts, tp,
                                  topt.schedule(cfg_t, step), cfg_t)
        assert ts.count == int(js.count) == i + 1
        _assert_tree_close(ts.mu, js.mu, 1e-6, f"mu step {i}")
        _assert_tree_close(ts.nu, js.nu, 1e-6, f"nu step {i}")
        # The parameter is old - step: hold it at its own rounding (rtol
        # 1e-6) plus the step's tolerance (1e-6 of lr at the first step,
        # 2e-5 of lr later, see the module docstring).
        lr = topt.schedule(cfg_t, step)
        for k in tp:
            np.testing.assert_allclose(
                tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                atol=(1e-6 if i == 0 else 2e-5) * lr)
            if i == 0:
                d = (tp[k] - tp_old[k]).numpy()
                np.testing.assert_allclose(np.abs(d), lr, rtol=1e-3)
        assert tp_old["bg"] is not tp["bg"]          # functional


def test_adam_update_is_sign_step_first():
    cfg = topt.AdamConfig(lr=0.5)
    p = torch.zeros(4)
    g = torch.tensor([1e-12, -1e-12, 3.0, 0.0])
    new_p, s = topt.adam_update(g, topt.init_adam(p), p, 0.5, cfg)
    np.testing.assert_allclose(new_p.numpy(), [-0.5, 0.5, -0.5, 0.0],
                               rtol=2e-3)      # eps is 1e-3 of 1e-12
    assert s.count == 1 and s.acc is None and s.calls is None


def test_adam_update_with_accumulation_matches_jax():
    cfg_j = jopt.AdamConfig(lr=1e-3, accum_steps=3)
    cfg_t = topt.AdamConfig(lr=1e-3, accum_steps=3)
    p0, gs = _trees(1)
    p0, gs = p0["bg"], [g["bg"] for g in gs] * 2
    jp, tp = jnp.asarray(p0), T(p0)
    js = jopt.init_adam(jp, accum_steps=3)
    ts = topt.init_adam(tp, accum_steps=3)
    assert ts.calls == 0 and not ts.acc.any()
    for i, g in enumerate(gs[:7]):
        jp, js = jopt.adam_update(jnp.asarray(g), js, jp, jnp.float32(1e-3),
                                  cfg_j)
        tp, ts = topt.adam_update(T(g), ts, tp, 1e-3, cfg_t)
        assert ts.calls == int(js.calls) == i + 1
        assert ts.count == int(js.count) == (i + 1) // 3
        np.testing.assert_allclose(ts.acc.numpy(), np.asarray(js.acc),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(ts.nu.numpy(), np.asarray(js.nu),
                                   rtol=1e-6, atol=1e-20)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=2e-5 * 1e-3)
    assert not np.array_equal(tp.numpy(), p0)


def test_mask_moments_matches_jax():
    rng = np.random.default_rng(2)
    mu = {"bg": rng.standard_normal((30, 4, 3)).astype(np.float32)}
    nu = {"bg": rng.random((30, 4, 3)).astype(np.float32)}
    keep = rng.random(30) > 0.4
    js = jopt.mask_moments(jopt.AdamState(
        mu={"bg": jnp.asarray(mu["bg"])}, nu={"bg": jnp.asarray(nu["bg"])},
        count=jnp.int32(5)), jnp.asarray(keep))
    ts = topt.mask_moments(topt.AdamState(
        mu={"bg": T(mu["bg"])}, nu={"bg": T(nu["bg"])}, count=5), T(keep))
    np.testing.assert_array_equal(ts.mu["bg"].numpy(), np.asarray(js.mu["bg"]))
    np.testing.assert_array_equal(ts.nu["bg"].numpy(), np.asarray(js.nu["bg"]))
    assert ts.count == 5 and not ts.mu["bg"][~T(keep)].any()
    # A leading object axis: keep (O, CAP) over moments (O, CAP, ...).
    keep2 = rng.random((2, 15)) > 0.5
    m = topt.mask_moments(topt.AdamState(
        mu=T(mu["bg"]).reshape(2, 15, 4, 3), nu=T(nu["bg"]).reshape(
            2, 15, 4, 3), count=1), T(keep2))
    assert not m.mu[~T(keep2)].any() and m.mu[T(keep2)].all()
