"""The analytic ODE case matrix of tests/test_ode_parity.py on the port's
phys_step (one env): the same 16 cases — closed-form rigid-body
trajectories under ODE's parameter semantics (symplectic Euler at 120 Hz,
per-step linear damping, bounce / bounce_vel, Coulomb contact friction,
capsule inertia) — with the same formulas and the same tolerances as the
JAX package's cases, as cases of one parametrised test:

free fall and the projectile (1e-5), rest on a plane (2e-3), bounce (8 %),
incline rolling 5/7 g sinθ (12 %), backspin to roll (10 %), the equal-mass
head-on pair (3 % of the relative speed), auto-disable (exact), kinematic
immunity (1e-6), the settled stack, the character pushing a box
(physics.c:677-693, through engine_step), the glancing pair's spin, the
solver-pass band (12 passes within 6 %), and the damped discrete
references of cases 4-6 (0.5 %, 1 %, 2e-3 / 2e-2). Cases that start
from the same scene read one run of it (rest: 3 and 8; bounce: 4 and 16;
incline: 5, 13 and 14; backspin: 6 and 15)."""
import functools

import numpy as np
import pytest
import torch

from clap_tpu_torch.char.controller import CharParams
from clap_tpu_torch.engine.state import (EntityParams, SceneConfig,
                                         engine_state_init, scene_host)
from clap_tpu_torch.engine.step import Inputs, engine_step
from clap_tpu_torch.physics import world as W
from clap_tpu_torch.physics.heightfield import make_heightfield
from clap_tpu_torch.physics.narrowphase import make_world
from clap_tpu_torch.bridge import tree_map
import test_torch_common  # noqa: F401  (one torch thread per worker)

H = W.FIXED_DT
DAMP = 1.0 - W.LINEAR_DAMPING
G = -9.8


def flat_world(h=0.0, n=17, side=32.0):
    hs = np.full((n, n), h, np.float32)
    nrm = np.zeros((n, n, 3), np.float32)
    nrm[..., 1] = 1.0
    return make_world(make_heightfield(hs, nrm, [-side / 2, -side / 2], side,
                                       device="cpu"))


def slope_world(slope=0.3, n=33, side=32.0):
    xs = np.linspace(-side / 2, side / 2, n).astype(np.float32)
    hs = np.broadcast_to(slope * xs[:, None], (n, n)).astype(np.float32)
    nrm = np.zeros((n, n, 3), np.float32)
    nrm[:] = np.array([-slope, 1.0, 0.0]) / np.sqrt(1 + slope ** 2)
    return make_world(make_heightfield(hs, nrm, [-side / 2, -side / 2], side,
                                       device="cpu"))


def bodies(n, slots):
    """Host BodyParams with per-slot fields (``slots``: {field: {slot:
    value}}), their inertia finalized; returns (host params, tensors)."""
    p = W.body_params_empty(n)
    for field, vals in slots.items():
        for i, v in vals.items():
            getattr(p, field)[i] = v
    p = W.finalize_inertia(p)
    return p, tree_map(torch.as_tensor, p)


def state(n, pos=None, vel=None, angvel=None, disabled=None):
    """One env's PhysState (B = 1) with the given per-slot values."""
    st = tree_map(lambda x: x[None].clone(),
                  engine_state_init(1, n, 1, device="cpu").phys)
    for field, vals in (("pos", pos), ("vel", vel), ("angvel", angvel),
                        ("disabled", disabled)):
        for i, v in (vals or {}).items():
            getattr(st, field)[0, i] = torch.as_tensor(v)
    return st


def one_sphere(r=0.5, pos=(0, 5, 0), bounce=0.0, bounce_vel=0.0, mu=1.0,
               n=4):
    host, params = bodies(n, dict(
        active={0: True}, radius={0: r}, bounce={0: bounce},
        bounce_vel={0: bounce_vel}, mu={0: mu}, yoffset={0: r},
        ray_off={0: r}))
    return (params, W.body_flags(host.half_len, host.kinematic)), \
        state(n, pos={0: pos})


def step(world, pf, st, dt=1 / 60, passes=W.N_SOLVER_PASSES):
    return W.phys_step(world, pf[0], st, dt, solver_passes=passes,
                       flags=pf[1])


def run_steps(world, pf, st, frames, dt=1 / 60, passes=W.N_SOLVER_PASSES):
    for _ in range(frames):
        st = step(world, pf, st, dt, passes)
    return st


def f(x):
    return float(x)


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _free_fall_closed_form(y0, steps):
    v, y = 0.0, y0
    for _ in range(steps):
        v = (v + G * H) * DAMP
        y = y + v * H
    return y, v


@case
def case01_free_fall_discrete_exact():
    pf, st = one_sphere(r=0.3, pos=(0, 50.0, 0))
    st = run_steps(flat_world(), pf, st, 30)
    y_ref, v_ref = _free_fall_closed_form(50.0, 60)
    assert f(st.pos[0, 0, 1]) == pytest.approx(y_ref, abs=1e-5)
    assert f(st.vel[0, 0, 1]) == pytest.approx(v_ref, abs=1e-5)


@case
def case02_projectile_x_exact():
    pf, st = one_sphere(r=0.3, pos=(0, 50.0, 0), mu=0.0)
    st.vel[0, 0, 0] = 3.0
    st = run_steps(flat_world(), pf, st, 30)
    v, x = 3.0, 0.0
    for _ in range(60):
        v = v * DAMP
        x = x + v * H
    assert f(st.pos[0, 0, 0]) == pytest.approx(x, abs=1e-5)


@functools.lru_cache(maxsize=None)
def _rest_run():
    """A sphere (r 0.5) resting on the plane: its state after frames 60,
    90, 150 and 180."""
    world = flat_world()
    pf, st = one_sphere(r=0.5, pos=(0, 0.5, 0))
    out = {}
    for frame in range(1, 181):
        st = step(world, pf, st)
        if frame in (60, 90, 150, 180):
            out[frame] = st
    return out


@case
def case03_rest_fixed_point():
    run = _rest_run()
    p1 = run[60].pos[0, 0].numpy()
    p2 = run[180].pos[0, 0].numpy()
    assert np.abs(p2 - p1).max() < 2e-3
    assert abs(p2[1] - 0.5) < 2e-3


@functools.lru_cache(maxsize=None)
def _bounce_run():
    """A bouncing sphere (r 0.5 from y 3, bounce 0.6, bounce_vel 0.05, no
    friction): (y, vy) after each frame, up to the first rebound apex."""
    world = flat_world()
    pf, st = one_sphere(r=0.5, pos=(0, 3.0, 0), bounce=0.6,
                        bounce_vel=0.05, mu=0.0)
    out = []
    for _ in range(300):
        st = step(world, pf, st)
        out.append((f(st.pos[0, 0, 1]), f(st.vel[0, 0, 1])))
        if len(out) > 1 and out[-2][1] > 0.5 >= out[-1][1]:
            break
    return out


@case
def case04_bounce_restitution():
    v_prev, impact = 0.0, None
    for _, v in _bounce_run():
        if v_prev < -1.0 and v > 0.0:
            impact, rebound = -v_prev, v
            break
        v_prev = v
    assert impact is not None, "never bounced"
    assert rebound == pytest.approx(0.6 * impact, rel=0.08)


SLOPE = 0.25
SIN_T = SLOPE / np.sqrt(1 + SLOPE * SLOPE)


@functools.lru_cache(maxsize=None)
def _incline_speed(passes: int, r=0.5):
    """A sphere (r 0.5, mu 1.5) rolling down the 0.25 slope from rest:
    its speed in the x-y plane after 45 frames with ``passes`` solver
    passes."""
    nv = np.array([-SLOPE, 1.0, 0.0]) / np.sqrt(1 + SLOPE * SLOPE)
    pf, st = one_sphere(r=r, pos=tuple(np.float32(r * nv)), mu=1.5)
    st = run_steps(slope_world(SLOPE), pf, st, 45, passes=passes)
    return np.linalg.norm(st.vel[0, 0].numpy()[[0, 1]])


@case
def case05_incline_rolling_5_7():
    v_expect = (5.0 / 7.0) * 9.8 * SIN_T * 45 / 60.0
    assert _incline_speed(4) == pytest.approx(v_expect, rel=0.12)


@functools.lru_cache(maxsize=None)
def _backspin_run(r=0.5, w0=6.0):
    """A sphere (r 0.5, mu 1.5) on the plane spinning at -6 rad/s about z:
    its state after 60 frames."""
    pf, st = one_sphere(r=r, pos=(0, r, 0), mu=1.5)
    st.angvel[0, 0] = torch.tensor([0.0, 0.0, -w0])
    return run_steps(flat_world(), pf, st, 60)


@case
def case06_backspin_to_roll():
    r, w0 = 0.5, 6.0
    st = _backspin_run()
    v = f(st.vel[0, 0, 0])
    assert v == pytest.approx(2.0 / 7.0 * w0 * r, rel=0.10)
    assert -f(st.angvel[0, 0, 2]) * r == pytest.approx(v, rel=0.02)


def _pair(mu, bounce, bounce_vel, yoffset):
    host, params = bodies(4, dict(
        active={0: True, 1: True}, radius={0: 0.5, 1: 0.5},
        yoffset={0: yoffset, 1: yoffset}, ray_off={0: 0.5, 1: 0.5},
        mu={0: mu, 1: mu}, bounce={0: bounce, 1: bounce},
        bounce_vel={0: bounce_vel, 1: bounce_vel}))
    return params, W.body_flags(host.half_len, host.kinematic)


@case
def case07_equal_mass_head_on():
    pf = _pair(0.0, 0.5, 0.01, 0.5)
    st = state(4, pos={0: [-1.5, 0.5, 0.0], 1: [1.5, 0.5, 0.0]},
               vel={0: [2.0, 0.0, 0.0], 1: [-2.0, 0.0, 0.0]})
    st = run_steps(flat_world(), pf, st, 40)
    v0, v1 = f(st.vel[0, 0, 0]), f(st.vel[0, 1, 0])
    assert abs(v0 + v1) < 0.05
    pre = 4.0 * (1.0 - W.LINEAR_DAMPING) ** 60
    assert abs(v1 - v0) == pytest.approx(0.5 * pre, rel=0.03)


@case
def case08_auto_disable_freezes():
    run = _rest_run()
    assert bool(run[90].disabled[0, 0])
    assert torch.equal(run[150].pos[0, 0], run[90].pos[0, 0])


@case
def case09_kinematic_immunity():
    host, params = bodies(4, dict(
        active={0: True, 1: True}, kinematic={0: True},
        radius={0: 0.3, 1: 0.3}, half_len={0: 0.4},
        yoffset={0: 1.0, 1: 0.3}, ray_off={0: 0.5, 1: 0.3}))
    pf = (params, W.body_flags(host.half_len, host.kinematic))
    st = state(4, pos={0: [0.0, 1.0, 0.0], 1: [0.0, 3.0, 0.0]})
    st = run_steps(flat_world(), pf, st, 120)
    np.testing.assert_allclose(st.pos[0, 0].numpy(), [0.0, 1.0, 0.0],
                               atol=1e-6)
    assert f(st.pos[0, 1, 1]) < 3.0


@case
def case10_stacked_spheres_settle():
    r = 0.5
    host, params = bodies(4, dict(
        active={0: True, 1: True}, radius={0: r, 1: r},
        yoffset={0: r, 1: r}, ray_off={0: r, 1: r}, mu={0: 1.0, 1: 1.0}))
    pf = (params, W.body_flags(host.half_len, host.kinematic))
    st = state(4, pos={0: [0.0, r, 0.0], 1: [0.0, 3 * r + 0.05, 0.0]})
    st = run_steps(flat_world(), pf, st, 300)
    assert f(st.pos[0, 0, 1]) == pytest.approx(r, abs=0.04)
    assert f(st.pos[0, 1, 1]) == pytest.approx(3 * r, abs=0.08)
    assert abs(f(st.pos[0, 1, 0])) + abs(f(st.pos[0, 1, 2])) < 0.25
    assert f(st.vel[0, 1].norm()) < 0.1


@case
def case11_character_pushes_box():
    """Walking into a disabled dynamic box wakes it and shoves it +x
    (phys_body_push, through engine_step)."""
    host, params = bodies(4, dict(
        active={0: True, 1: True}, kinematic={0: True},
        radius={0: 0.3, 1: 0.4}, half_len={0: 0.4},
        yoffset={0: 1.0, 1: 0.4}, ray_off={0: 0.5, 1: 0.4},
        mass={0: 70.0, 1: 5.0}, mu={1: 0.1}))
    E = 4
    ent = tree_map(torch.as_tensor, EntityParams(
        active=np.array([False, True, True, False]),
        model_id=np.zeros(E, np.int32),
        body=np.array([-1, 0, 1, -1], np.int32),
        body_is_char=np.array([False, True, False, False]),
        yoffset=np.zeros(E, np.float32), parent=np.full(E, -1, np.int32),
        skip_culling=np.zeros(E, bool)))
    cp = CharParams(body=torch.tensor([0], dtype=torch.int32),
                    lin_speed=torch.tensor([2.4]),
                    jump_forward=torch.tensor([1.2]),
                    jump_upward=torch.tensor([5.0]),
                    can_dash=torch.tensor([True]))
    cfg = SceneConfig(world=flat_world(), bodies=params, entities=ent,
                      char_params=cp, model_aabb=torch.zeros(1, 2, 3),
                      limbo_height=torch.tensor(40.0),
                      gravity_y=torch.tensor(-9.8),
                      host=scene_host(host, [0]))
    st = tree_map(lambda x: x[None].clone(),
                  engine_state_init(E, 4, 1, device="cpu"))
    st.phys.pos[0, 0] = torch.tensor([0.0, 1.0, 0.0])
    st.phys.pos[0, 1] = torch.tensor([1.6, 0.4, 0.0])
    st.phys.disabled[0, 1] = True
    walk = Inputs(motion=torch.tensor([[[1.0, 0.0]]]),
                  jump=torch.zeros(1, 1, dtype=torch.bool),
                  cam_delta=torch.zeros(1, 3),
                  dash=torch.zeros(1, 1, dtype=torch.bool))
    for _ in range(90):
        st = engine_step(cfg, st, walk)
    assert f(st.phys.pos[0, 1, 0]) > 1.75, st.phys.pos[0, 1]
    assert f(st.phys.pos[0, 0, 0]) > 0.4


@case
def case12_glancing_pair_collision_spins():
    r = 0.5
    pf = _pair(1.0, 0.0, 0.0, 10.0)
    st = state(4, pos={0: [-1.2, 20.0, 0.0], 1: [1.2, 20.0, 0.8 * r]},
               vel={0: [6.0, 0.0, 0.0], 1: [-6.0, 0.0, 0.0]})
    st = run_steps(flat_world(), pf, st, 25)
    assert abs(f(st.angvel[0, 0, 1])) > 0.2
    assert abs(f(st.angvel[0, 1, 1])) > 0.2
    assert abs(f(st.vel[0, 0, 0] + st.vel[0, 1, 0])) < 0.1


@case
def case13_solver_passes_shrink_contact_band():
    v_expect = (5.0 / 7.0) * 9.8 * SIN_T * 45 / 60.0
    err4 = abs(_incline_speed(4) - v_expect) / v_expect
    err12 = abs(_incline_speed(12) - v_expect) / v_expect
    assert err12 <= err4 + 1e-6, (err4, err12)
    assert err12 < 0.06, err12


@case
def case14_incline_damped_reference_tight():
    speed = _incline_speed(4)
    v_ref = 0.0
    for _ in range(90):
        v_ref += (5.0 / 7.0) * 9.8 * SIN_T * H
        v_ref *= 1.0 - 5.0 * W.LINEAR_DAMPING / 7.0
    assert speed == pytest.approx(v_ref, rel=5e-3), (speed, v_ref)


@case
def case15_backspin_damped_reference_tight():
    r, w0, mu = 0.5, 6.0, 1.5
    v = f(_backspin_run().vel[0, 0, 0])
    n_slip = int(np.ceil(w0 * r / (3.5 * mu * 9.8 * H)))
    v_ref = (2.0 / 7.0) * w0 * r \
        * (1.0 - 5.0 * W.LINEAR_DAMPING / 7.0) ** (120 - n_slip)
    assert v == pytest.approx(v_ref, rel=0.01), (v, v_ref)


@case
def case16_bounce_damped_reference_tight():
    r, bounce, bvel, y0 = 0.5, 0.6, 0.05, 3.0
    y, v, refs = y0, 0.0, []
    for k in range(400):
        depth = r - y
        if depth > 0:
            y += depth
        v += G * H
        if depth > -W.CONTACT_MARGIN and v < -bvel:
            v = -bounce * v
        v *= DAMP
        y += v * H
        if k % 2 == 1:
            refs.append((y, v))
    run = _bounce_run()
    assert run[-1][1] <= 0.5 < run[-2][1]
    for i, (y, v) in enumerate(run[:200]):
        y_ref, v_ref = refs[i]
        assert y == pytest.approx(y_ref, abs=2e-3), i
        assert v == pytest.approx(v_ref, abs=2e-2), i
        if v > 0.5:
            break


@pytest.mark.parametrize("name", sorted(CASES))
def test_ode_case(name):
    CASES[name]()


def test_case_matrix_is_complete():
    assert len(CASES) == 16
