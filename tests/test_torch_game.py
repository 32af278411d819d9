"""The port's game layer against the JAX package: clips, joints, queue,
skinning and anim_step on the rigs of tests/test_anim.py::make_rig and
tests/test_anim_system.py::make_lib (within 1e-5); game_update (exact);
particles with the JAX package's draws injected (within 1e-6); 5 frames of
game_step on tests/test_game_step.py::build_gameworld (with joint riding,
head targeting and sfx events on) over 2 envs (within 1e-4); and the
composed step_and_render through game_step at the size of
test_torch_slice.py (state within 1e-4, LDR PSNR >= 35 dB)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu import mathx as jmx
from clap_tpu.anim import clips as Jc
from clap_tpu.anim import joints as Jj
from clap_tpu.anim import queue as Jq
from clap_tpu.anim import skin as Js
from clap_tpu.anim import system as Jsys
from clap_tpu.engine import game as Jg
from clap_tpu.engine import gamelogic as Jgl
from clap_tpu.engine.step import inputs_zero
from clap_tpu.ops import particles as Jp
from clap_tpu.render import pipeline as jpl
from clap_tpu.render import scenerender as jsr
from clap_tpu.scene import testbed as jtb
from clap_tpu_torch.anim import clips as Tc
from clap_tpu_torch.anim import joints as Tj
from clap_tpu_torch.anim import queue as Tq
from clap_tpu_torch.anim import skin as Ts
from clap_tpu_torch.anim import system as Tsys
from clap_tpu_torch.engine import gamelogic as Tgl
from clap_tpu_torch.engine.frame import SceneRenderer, step_and_render
from clap_tpu_torch.engine.game import GameSessionState, game_step
from clap_tpu_torch.engine.step import Inputs
from clap_tpu_torch.ops import particles as Tp
from clap_tpu_torch.render import pipeline as tpl
from clap_tpu_torch.render import scenerender as tsr
from clap_tpu_torch.scene import testbed as ttb
from test_anim import make_rig
from test_anim_system import make_lib
from test_game_step import build_gameworld
from test_torch_common import (assert_tree_close, assert_tree_equal,
                               jnp_tree, psnr, to_port)
from test_torch_render import (LOD_SCALE, OPTS, RES, composed_scene,
                               jax_views)

ANIM_TOL = dict(atol=1e-5, rtol=1e-5)


def _quats(rng, shape):
    q = rng.standard_normal((*shape, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def extra_clips(pad=False):
    """Rotation, scale and multi-key channels next to make_lib's
    translation clips. With ``pad`` the second clip has a channel fewer
    than the first, so the library pads it."""
    rng = np.random.default_rng(5)
    keys = np.linspace(0.0, 1.5, 6)
    second = [(2, Jc.PATH_TRANSLATION, [0.0, 0.5], [[0, 1, 0], [0, 2, 0]]),
              (0, Jc.PATH_ROTATION, [0.0, 2.0], _quats(rng, (2,)))]
    if not pad:
        second.append((1, Jc.PATH_SCALE, [0.0, 1.0],
                       [[1, 1, 1], [0.8, 1.1, 1]]))
    return [
        [(1, Jc.PATH_TRANSLATION, [0.0, 1.0], [[0, 1, 0], [1, 1, 0]]),
         (2, Jc.PATH_ROTATION, keys, _quats(rng, (6,))),
         (0, Jc.PATH_SCALE, [0.0, 0.5, 1.0],
          [[1, 1, 1], [1.2, 1, 0.9], [1, 1, 1]])],
        second,
    ]


def branching_rig(n_joints=11, seed=2):
    """bench.py:88-97's rig shape (parent (i-1)//2) with random rest
    translations and inverse binds."""
    rng = np.random.default_rng(seed)
    parent = [-1] + [(i - 1) // 2 for i in range(1, n_joints)]
    invbind = np.tile(np.eye(4, dtype=np.float32), (n_joints, 1, 1))
    invbind[:, :3, 3] = rng.standard_normal((n_joints, 3)) * 0.2
    args = (parent, invbind,
            rng.standard_normal((n_joints, 3)).astype(np.float32) * 0.1,
            _quats(rng, (n_joints,)), np.ones((n_joints, 3), np.float32))
    return Jj.build_skeleton(*args), Tj.build_skeleton(*args, device="cpu")


# ---------------------------------------------------------------------------
# clips, joints, queue, skin
# ---------------------------------------------------------------------------

def test_build_library_and_skeleton_match_jax():
    clips = extra_clips()
    assert_tree_equal(jnp_tree(Jc.build_library(clips, 3)),
                      Tc.build_library(clips, 3, device="cpu"))
    jsk, tsk = branching_rig()
    assert_tree_equal(jnp_tree(jsk), tsk)


@pytest.mark.parametrize("which", ["make_lib", "extra"])
def test_sample_pose_matches_jax(which):
    jlib = make_lib()[0] if which == "make_lib" \
        else Jc.build_library(extra_clips(), 3)
    sk = make_rig()
    rng = np.random.default_rng(7)
    n = 24
    ids = rng.integers(0, jlib.times.shape[0], n).astype(np.int32)
    ts = rng.uniform(-0.2, 2.2, n).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda i, t: Jc.sample_pose(jlib, sk.base, i, t)))(
        jnp.asarray(ids), jnp.asarray(ts))
    got = Tc.sample_pose(to_port(jlib), to_port(sk.base), torch.as_tensor(ids),
                         torch.as_tensor(ts))
    assert_tree_close(jnp_tree(ref), got, **ANIM_TOL)


def test_padded_channels_add_nothing():
    """A clip padded to the library's channel count samples as it does in
    a library of its own. (The JAX package's one-hot scatter multiplies
    the padding's NaN slerp by zero, which poisons every joint; the port
    masks the padding out instead.)"""
    clip = extra_clips(pad=True)[1]
    sk = make_rig()
    ts = torch.linspace(-0.1, 1.9, 9)     # inside the clip: same keys
    padded = Tc.sample_pose(Tc.build_library(extra_clips(pad=True), 3, "cpu"),
                            to_port(sk.base), torch.ones(9, dtype=torch.long),
                            ts)
    alone = Tc.sample_pose(Tc.build_library([clip], 3, "cpu"),
                           to_port(sk.base), torch.zeros(9, dtype=torch.long),
                           ts)
    jlib = Jc.build_library([clip], 3)
    ref = jax.jit(jax.vmap(lambda t: Jc.sample_pose(jlib, sk.base,
                                                    jnp.int32(0), t)))(
        jnp.asarray(ts.numpy()))
    assert all(bool(torch.isfinite(x).all()) for x in padded)
    assert_tree_close(jnp_tree(ref), padded, **ANIM_TOL)
    for a, b in zip(alone, padded):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rig", ["make_rig", "branching"])
def test_joint_matrices_match_jax(rig):
    if rig == "make_rig":
        jsk = make_rig()
        glob_rest = Jj.global_matrices(jsk, Jj.local_matrices(jsk.base))
        jsk = jsk._replace(invbind=jnp.linalg.inv(glob_rest))
    else:
        jsk = branching_rig()[0]
    J = jsk.parent.shape[0]
    rng = np.random.default_rng(11)
    B = 6
    pose = Jc.Pose(
        trans=jnp.asarray(rng.standard_normal((B, J, 3)).astype(np.float32)),
        rot=jnp.asarray(_quats(rng, (B, J))),
        scale=jnp.asarray(rng.uniform(0.8, 1.2, (B, J, 3)).astype(np.float32)))
    ref = jax.jit(jax.vmap(lambda p: Jj.joint_matrices(jsk, p)))(pose)
    tsk, tpose = to_port(jsk), to_port(pose)
    got = Tj.joint_matrices(tsk, tpose)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ANIM_TOL)
    glob = jax.jit(jax.vmap(lambda p: Jj.global_matrices(
        jsk, Jj.local_matrices(p))))(pose)
    np.testing.assert_allclose(
        Tj.global_matrices(tsk, Tj.local_matrices(tpose)).numpy(),
        np.asarray(glob), **ANIM_TOL)


def test_queue_matches_jax():
    """Random pushes (clear or append, with a full queue dropping) and
    advances over 6 queues; ints exact, time within 1e-5."""
    B = 6
    durations = np.array([1.0, 0.4, 2.5], np.float32)
    rng = np.random.default_rng(3)
    jq = jax.tree.map(lambda x: jnp.broadcast_to(x, (B, *x.shape)),
                      Jq.queue_init())
    tq = Tq.AnimQueue(*(x.expand(B, *x.shape) for x in Tq.queue_init("cpu")))
    push = jax.jit(jax.vmap(Jq.queue_push))
    adv = jax.jit(jax.vmap(Jq.queue_advance, in_axes=(0, None, None)))
    for step in range(14):
        if step % 2 == 0:
            clip = rng.integers(0, 3, B).astype(np.int32)
            rep = rng.uniform(size=B) < 0.5
            clear = rng.uniform(size=B) < 0.3
            jq = push(jq, jnp.asarray(clip), jnp.asarray(rep),
                      jnp.asarray(clear))
            tq = Tq.queue_push(tq, torch.as_tensor(clip),
                               torch.as_tensor(rep), torch.as_tensor(clear))
            assert_tree_close(jnp_tree(jq), tq, **ANIM_TOL)
        else:
            dt = float(rng.uniform(0.1, 0.9))
            jq, jend, jact = adv(jq, jnp.asarray(durations), jnp.float32(dt))
            tq, tend, tact = Tq.queue_advance(tq, torch.as_tensor(durations),
                                              dt)
            assert_tree_close(jnp_tree((jq, jend, jact)), (tq, tend, tact),
                              **ANIM_TOL)


def test_skinning_matches_jax():
    rng = np.random.default_rng(3)
    B, J, V = 5, 7, 33
    jts = np.tile(np.eye(4, dtype=np.float32), (B, J, 1, 1))
    jts[:, :, :3, :3] += rng.standard_normal((B, J, 3, 3)) * 0.3
    jts[:, :, :3, 3] = rng.standard_normal((B, J, 3))
    verts = rng.standard_normal((V, 3)).astype(np.float32)
    normals = rng.standard_normal((V, 3)).astype(np.float32)
    w = rng.random((V, 4)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    ji = rng.integers(0, J, (V, 4)).astype(np.int32)
    j = [jnp.asarray(a) for a in (verts, normals, w, ji)]
    t = [torch.as_tensor(a) for a in (verts, normals, w, ji)]
    ref = Js.skin_verts_batch(jnp.asarray(jts), *j)
    got = Ts.skin_verts_batch(torch.as_tensor(jts), *t)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **ANIM_TOL)
    ref1 = Js.skin_verts(jnp.asarray(jts[2]), *j)
    got1 = Ts.skin_verts(torch.as_tensor(jts[2]), *t)
    for a, b in zip(ref1, got1):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **ANIM_TOL)
    np.testing.assert_allclose(
        Ts.blend_matrix(t[2], t[3], J).numpy(),
        np.asarray(Js.blend_matrix(j[2], j[3], J)), **ANIM_TOL)


@pytest.mark.parametrize("with_sfx", [False, True])
def test_anim_step_matches_jax(with_sfx):
    """12 frames of state-driven clips over (2 envs, 2 rigs): transitions,
    loops, pops and (with the table) footstep events."""
    sk = make_rig()
    jlib, names = make_lib()
    names = names + ["fall"]
    jlib = Jc.build_library(
        [[(1, Jc.PATH_TRANSLATION, [0.0, 1.0], [[0, 1, 0], [0, 1, 0]])],
         [(1, Jc.PATH_TRANSLATION, [0.0, 1.0], [[0, 1, 0], [1, 1, 0]])],
         [(2, Jc.PATH_TRANSLATION, [0.0, 0.5], [[0, 1, 0], [0, 2, 0]])],
         [(2, Jc.PATH_ROTATION, [0.0, 0.7],
           [[0, 0, 0, 1], [0, 0.7071, 0, 0.7071]])]], 3)
    acfg = Jsys.default_state_map(names)
    sfx = Jsys.anim_sfx_from_names(names) if with_sfx else None
    tsfx = Tsys.anim_sfx_from_names(names, device="cpu") if with_sfx else None
    assert_tree_equal(jnp_tree(acfg), Tsys.default_state_map(names, "cpu"))
    if with_sfx:
        assert_tree_equal(jnp_tree(sfx), tsfx)
    E, C = 2, 2
    jinst = jax.tree.map(lambda x: jnp.broadcast_to(x, (E, *x.shape)),
                         Jsys.anim_instances_init(C, with_sfx))
    tinst = ttb.replicate_state(
        Tsys.anim_instances_init(C, with_sfx, device="cpu"), E)
    def one(i, s):
        return Jsys.anim_step(acfg, sk, jlib, i, s, jnp.float32(0.15),
                              sfx=sfx)

    jstep = jax.jit(jax.vmap(jax.vmap(one)))
    targs = (to_port(acfg), to_port(sk), to_port(jlib))
    rng = np.random.default_rng(1)
    states = rng.integers(0, Tsys.N_STATES, (12, E, C)).astype(np.int32)
    states[3:6] = 3                   # hold MOVING: loops and footsteps
    for s in states:
        ref = jstep(jinst, jnp.asarray(s))
        got = Tsys.anim_step(*targs, tinst, torch.as_tensor(s), 0.15,
                             sfx=tsfx)
        assert_tree_close(jnp_tree(ref), got, **ANIM_TOL)
        jinst, tinst = ref[0], got[0]


def test_build_demo_rig_matches_jax():
    assert_tree_equal(jnp_tree(jtb.build_demo_rig()),
                      ttb.build_demo_rig(device="cpu"))


# ---------------------------------------------------------------------------
# game rules, particles
# ---------------------------------------------------------------------------

def test_game_update_matches_jax():
    """Random switches, platform groups, grounds and rosters over 8 envs,
    three ticks; every output exact."""
    rng = np.random.default_rng(4)
    B, K, E, C = 8, 3, 8, 3
    g0 = Jgl.game_config_empty(K, E)
    group = np.full(E, -1, np.int32)
    group[[2, 3, 5]] = [0, 1, 1]
    jcfg = g0._replace(
        switch_entity=jnp.asarray([0, 4, 6], jnp.int32),
        switch_permanent=jnp.asarray([True, False, False]),
        switch_group=jnp.asarray([0, 1, 1], jnp.int32),
        switch_valid=jnp.asarray([True, True, False]),
        platform_group=jnp.asarray(group),
        platform_on_pos=jnp.asarray(rng.standard_normal((E, 3)),
                                    jnp.float32),
        connect_radius=jnp.float32(2.0))
    tcfg = to_port(jcfg)
    assert_tree_equal(jnp_tree(Jgl.game_config_empty(K, E)),
                      Tgl.game_config_empty(K, E, device="cpu"))
    jgs = jax.tree.map(lambda x: jnp.broadcast_to(x, (B, *x.shape)),
                       Jgl.game_state_init(K, C))
    tgs = ttb.replicate_state(Tgl.game_state_init(K, C, device="cpu"), B)
    assert_tree_equal(jnp_tree(jgs), tgs)
    upd = jax.jit(jax.vmap(lambda s, g, p, y, n: Jgl.game_update(
        jcfg, s, g, p, y, n)))
    for _ in range(3):
        ground = rng.integers(-1, E, B).astype(np.int32)
        pos = (rng.standard_normal((B, C, 3)) * 2).astype(np.float32)
        y = rng.uniform(-200, 10, B).astype(np.float32)
        nxt = rng.uniform(size=B) < 0.5
        ref = upd(jgs, *map(jnp.asarray, (ground, pos, y, nxt)))
        got = Tgl.game_update(tcfg, tgs, *map(torch.as_tensor,
                                              (ground, pos, y, nxt)))
        assert_tree_equal(jnp_tree(ref), got)
        jgs, tgs = ref[0], got[0]


def jax_particle_draws(key, n_systems):
    """The uniform draws jax's particles_update takes from ``key``
    (particles.py:83-91)."""
    _k, k1, k2 = jax.random.split(key, 3)
    k1a, k1b = jax.random.split(k1)
    shape = (n_systems, Jp.PARTICLES_MAX)
    return (jax.random.uniform(k1a, (*shape, 3), minval=-1.0, maxval=1.0),
            jax.random.uniform(k1b, shape),
            jax.random.uniform(k2, (*shape, 3), minval=-1.0, maxval=1.0))


def test_particles_update_with_jax_draws():
    """The four radial distributions; respawn and Euler step within
    1e-6, with the JAX package's draws fed to the port."""
    params = Jp.ParticleParams(
        active=jnp.ones(4, bool), radius=jnp.asarray([1.5, 1.0, 2.0, 0.8]),
        min_radius=jnp.asarray([0.5, 0.0, 1.0, 0.2]),
        velocity=jnp.asarray([0.05, 0.2, 0.1, 0.3]),
        dist=jnp.arange(4, dtype=jnp.int32),
        count=jnp.full(4, Jp.PARTICLES_MAX, jnp.int32))
    tparams = to_port(params)
    centers = jnp.asarray(np.random.default_rng(0).standard_normal((4, 3)),
                          jnp.float32)
    st = Jp.particles_init(params, centers, jax.random.PRNGKey(4))
    tst = Tp.ParticleState(pos=torch.as_tensor(np.array(st.pos)),
                           vel=torch.as_tensor(np.array(st.vel)))
    n_escaped = 0
    for f in range(4):
        c = centers + 0.4 * f
        d = np.asarray(st.pos) - np.asarray(c)[:, None]
        n_escaped += int(((d * d).sum(-1) > np.asarray(
            params.radius)[:, None] ** 2).sum())
        draws = [torch.as_tensor(np.array(x))
                 for x in jax_particle_draws(st.key, 4)]
        st = Jp.particles_update(params, st, c)
        tst = Tp.particles_advance(tparams, tst,
                                   torch.as_tensor(np.array(c)), *draws)
        for a, b in zip((st.pos, st.vel), tst):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                       rtol=1e-6)
    assert n_escaped > 0


def test_particles_from_a_generator():
    params = Tp.ParticleParams(
        active=torch.ones(2, dtype=torch.bool),
        radius=torch.tensor([1.5, 1.0]), min_radius=torch.tensor([0.5, 0.2]),
        velocity=torch.tensor([0.05, 0.1]),
        dist=torch.tensor([1, 3], dtype=torch.int32),
        count=torch.full((2,), Tp.PARTICLES_MAX, dtype=torch.int32))
    centers = torch.zeros((3, 2, 3))
    gen = torch.Generator().manual_seed(0)
    st = Tp.particles_init(params, centers, gen)
    assert st.pos.shape == (3, 2, Tp.PARTICLES_MAX, 3)
    r = st.pos.norm(dim=-1)
    assert bool((r >= params.min_radius[:, None] - 1e-5).all())
    assert bool((r <= params.radius[:, None] + 1e-5).all())
    st2 = Tp.particles_update(params, st, centers, gen)
    assert bool(torch.equal(st2.pos, st.pos + st.vel))   # none escaped
    again = Tp.particles_init(params, centers,
                              torch.Generator().manual_seed(0))
    assert torch.equal(again.pos, st.pos)


# ---------------------------------------------------------------------------
# game_step: 5 frames on build_gameworld over 2 envs
# ---------------------------------------------------------------------------

B, FRAMES = 2, 5


def port_session(gs, n_envs):
    """The port's GameSessionState for a JAX-package session (particles
    carried as positions and velocities), replicated over envs."""
    parts = None
    if gs.particles is not None:
        parts = Tp.ParticleState(
            pos=torch.as_tensor(np.array(gs.particles.pos)),
            vel=torch.as_tensor(np.array(gs.particles.vel)))
    return ttb.replicate_state(GameSessionState(
        engine=to_port(gs.engine), game=to_port(gs.game),
        anim=to_port(gs.anim), particles=parts,
        joint_mats=torch.as_tensor(np.array(gs.joint_mats)),
        sfx_events=None if gs.sfx_events is None
        else torch.as_tensor(np.array(gs.sfx_events))), n_envs)


def seeded_inputs(rng, n_chars):
    mot = rng.uniform(-1, 1, (B, n_chars, 2)).astype(np.float32)
    mot[:, 0] = (1.0, 0.0)                       # char 0 walks +x
    mot[1, 0] = (0.6, -0.5)
    jmp = rng.uniform(size=(B, n_chars)) < 0.2
    cam = rng.uniform(-0.05, 0.05, (B, 3)).astype(np.float32)
    jins = inputs_zero(n_chars)._replace(
        motion=jnp.asarray(mot), jump=jnp.asarray(jmp),
        cam_delta=jnp.asarray(cam), dash=jnp.zeros((B, n_chars), bool))
    tins = Inputs(motion=torch.as_tensor(mot), jump=torch.as_tensor(jmp),
                  cam_delta=torch.as_tensor(cam),
                  dash=torch.zeros((B, n_chars), dtype=torch.bool))
    return jins, tins


def full_gameworld():
    """build_gameworld with every optional wiring of game_step on: entity
    6 rides joint 1 of the character (as test_joint_riding_attachment
    sets it), the camera aims at the head joint, footstep sfx events."""
    gw, gs = build_gameworld()
    E = gw.scene.entities.active.shape[0]
    ent = gw.scene.entities._replace(
        parent=gw.scene.entities.parent.at[6].set(1),
        active=gw.scene.entities.active.at[6].set(True))
    gw = gw._replace(
        scene=gw.scene._replace(entities=ent),
        attach_joint=jnp.full((E,), -1, jnp.int32).at[6].set(1),
        attach_offset=jnp.zeros((E, 3)).at[6].set(jnp.array([0.0, 0.1, 0.0])),
        head_joint=jnp.array([2], jnp.int32),
        char_entity=jnp.array([1], jnp.int32),
        char_height=jnp.array([2.0], jnp.float32),
        sfx=Jsys.anim_sfx_from_names(make_lib()[1]))
    gs = gs._replace(anim=Jsys.anim_instances_init(1, with_sfx=True),
                     sfx_events=jnp.zeros((1, 2), bool))
    return gw, gs


@pytest.fixture(scope="module")
def game_frames():
    jgw, jgs = full_gameworld()
    tgw = to_port(jgw)
    jss = jax.tree.map(lambda x: jnp.broadcast_to(x, (B, *x.shape)), jgs)
    tss = port_session(jgs, B)
    step = jax.jit(jax.vmap(lambda s, i: Jg.game_step(jgw, s, i)))
    draws = jax.jit(jax.vmap(lambda k: jax_particle_draws(k, 1)))
    rng = np.random.default_rng(0)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        for _ in range(FRAMES):
            jins, tins = seeded_inputs(rng, 1)
            d = [torch.as_tensor(np.array(x))
                 for x in draws(jss.particles.key)]
            mp.setattr(Tp, "particle_draws", lambda *a, **k: d)
            jss = step(jss, jins)
            tss = game_step(tgw, tss, tins)
            out.append((jnp_tree(jss), tss))
    return out


GAME_PARTS = {
    "engine": lambda s: s.engine,
    "game": lambda s: s.game,
    "anim": lambda s: s.anim,
    "joint_mats": lambda s: s.joint_mats,
    "sfx_events": lambda s: s.sfx_events,
    "particles": lambda s: (s.particles.pos, s.particles.vel),
}


@pytest.mark.parametrize("part", sorted(GAME_PARTS))
@pytest.mark.parametrize("frame", range(FRAMES))
def test_game_step_trajectory(game_frames, frame, part):
    ref, got = game_frames[frame]
    r, g = GAME_PARTS[part](ref), GAME_PARTS[part](got)
    assert_tree_close(r, g, path=part)


def test_game_step_plays(game_frames):
    """The frames do what test_game_step.py checks of the JAX step: the
    permanent terrain switch latches, the platform shows, an animation
    clip plays, the joint matrices stay finite and the rider stays near
    its character."""
    last = game_frames[-1][1]
    assert (last.engine.frame == FRAMES).all()
    rider = (last.engine.pos[:, 6] - last.engine.pos[:, 1]).norm(dim=-1)
    assert bool((rider < 3.0).all())
    assert bool(last.game.switch_on[:, 0].all())
    assert bool(last.engine.visible[:, 5].all())
    assert bool((last.anim.queue.clip[..., 0] >= 0).all())
    assert bool(torch.isfinite(last.joint_mats).all())


# ---------------------------------------------------------------------------
# the composed frame through game_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def composed_frames():
    J, T, jrt, trt, jl, tl = composed_scene()
    n_ents = J.cfg.entities.active.shape[0]
    g0 = Jgl.game_config_empty(1, n_ents)
    jgcfg = g0._replace(switch_entity=jnp.array([0], jnp.int32),
                        switch_valid=jnp.array([True]),
                        switch_permanent=jnp.array([True]))
    sk, lib, acfg = jtb.build_demo_rig()
    jgw = Jg.GameWorld(scene=J.cfg, game=jgcfg, anim=acfg, anim_sk=sk,
                       anim_lib=lib)
    jgs1 = Jg.GameSessionState(
        engine=J.state0, game=Jgl.game_state_init(1, 2),
        anim=Jsys.anim_instances_init(2),
        joint_mats=jnp.tile(jnp.eye(4, dtype=jnp.float32), (2, 3, 1, 1)))
    tgw = to_port(jgw)._replace(scene=T.cfg)
    tss = port_session(jgs1, B)
    jss = jax.tree.map(lambda x: jnp.broadcast_to(x, (B, *x.shape)), jgs1)

    jopts = jpl.RenderOptions(**OPTS)
    proj = jmx.mat4_perspective(jnp.pi / 3, 1.0, 0.1, 200.0)
    skip = J.cfg.entities.skip_culling
    jstatic = jsr.bake_static_shadow(jrt, J.state0.mx, jl.direction[0],
                                     shadow_size=128, far=200.0)

    @jax.jit
    def jax_step_and_render(gss, ins):           # bench.py:668-684
        gss = jax.vmap(lambda s, i: Jg.game_step(jgw, s, i))(gss, ins)
        sts = gss.engine
        views, planes = jax_views(sts.camera, proj)
        geom, axes = jsr.assemble_cluster_records_batch(
            jrt, sts.mx, sts.visible, planes, sts.camera.pos, views, proj,
            cap=jopts.record_compact, skip_culling=skip, lod_scale=LOD_SCALE)
        return gss, jpl.render_frame_dynamic_batch(
            jopts, geom, axes, views, proj, jl, sts.camera.pos, far=200.0,
            static_shadow=jstatic)

    tstatic = tsr.bake_static_shadow(trt, T.state0.mx, tl.direction[0],
                                     shadow_size=128, far=200.0)
    renderer = SceneRenderer(trt, tl, tpl.RenderOptions(**OPTS),
                             skip_culling=T.cfg.entities.skip_culling,
                             static_shadow=tstatic, lod_scale=LOD_SCALE)
    rng = np.random.default_rng(2)
    out = []
    for _ in range(2):
        jins, tins = seeded_inputs(rng, 2)
        jss, jimg = jax_step_and_render(jss, jins)
        tss, timg = step_and_render(tgw, renderer, tss, tins)
        out.append((jnp_tree(jss), np.asarray(jimg), tss, timg.numpy()))
    return out


@pytest.mark.parametrize("frame", range(2))
def test_composed_game_state(composed_frames, frame):
    jss, _, tss, _ = composed_frames[frame]
    for part in ("engine", "game", "anim", "joint_mats"):
        assert_tree_close(getattr(jss, part), getattr(tss, part),
                          path=f"frame{frame}.{part}")


@pytest.mark.parametrize("env", range(B))
@pytest.mark.parametrize("frame", range(2))
def test_composed_game_images(composed_frames, frame, env):
    _, jimg, _, timg = composed_frames[frame]
    assert timg.shape == (B, RES, RES, 3) and np.isfinite(timg).all()
    assert float(timg[env].std()) > 0.01
    assert psnr(jimg[env], timg[env]) >= 35.0
