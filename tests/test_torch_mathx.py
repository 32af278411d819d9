"""clap_tpu_torch.mathx against clap_tpu.mathx on the tests/test_mathx.py
cases: the same float32 inputs (from a numpy seed) through both, atol 1e-6
(float32 rounding of values of order one)."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clap_tpu import mathx as jmx
from clap_tpu_torch import mathx as tmx


def rand_quat(rng, n=()):
    q = rng.standard_normal((*n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _qmul(m, rng):
    p, q = rand_quat(rng, (32,)), rand_quat(rng, (32,))
    return m.qmul(*m_in(m, p, q))


def m_in(m, *xs):
    """The inputs as the module's own array type."""
    if m is jmx:
        return tuple(jnp.asarray(x) for x in xs)
    return tuple(torch.as_tensor(x) for x in xs)


def _qrot(m, rng):
    q = rand_quat(rng, (32,))
    v = rng.standard_normal((32, 3)).astype(np.float32)
    return m.qrot(*m_in(m, q, v))


def _mat3(m, rng):
    return m.mat3_from_quat(*m_in(m, rand_quat(rng, (8,))))


def _quat_from_mat3(m, rng):
    q, = m_in(m, rand_quat(rng, (64,)))
    return m.quat_from_mat3(m.mat3_from_quat(q))


def _euler(m, rng):
    ang = rng.uniform(-1.2, 1.2, (16, 3)).astype(np.float32)
    x, y, z = m_in(m, ang[:, 0], ang[:, 1], ang[:, 2])
    q = m.quat_from_euler_xyz(x, y, z)
    return (q,) + tuple(m.quat_to_euler_xyz(q))


def _slerp(m, rng):
    a, b = m_in(m, rand_quat(rng, (8,)), rand_quat(rng, (8,)))
    return tuple(m.qslerp(a, b, t) for t in (0.0, 0.5, 1.0))


def _trs(m, rng):
    pos = rng.standard_normal((8, 3)).astype(np.float32)
    q = rand_quat(rng, (8,))
    s = rng.uniform(0.5, 2.0, (8,)).astype(np.float32)
    mm = m.mat4_compose_trs(*m_in(m, pos, q, s))
    return mm, m.mat4_inverse_rigid(mm)


def _view(m, rng):
    pos = rng.standard_normal((8, 3)).astype(np.float32)
    q = rand_quat(rng, (8,))
    v = m.transform_view_mat4(*m_in(m, pos, q))
    return v, m.mat4_transform_point(v, m_in(m, pos)[0])


def _look_at(m, rng):
    eye, center, up = m_in(m, np.array([1.0, 2.0, 3.0], np.float32),
                           np.array([4.0, 2.0, 3.0], np.float32),
                           np.array([0.0, 1.0, 0.0], np.float32))
    v = m.mat4_look_at(eye, center, up)
    return v, m.mat4_transform_point(v, center), \
        m.mat4_look_at_safe(eye, eye + up, up)


def _perspective(m, rng):
    return m.mat4_perspective(math.pi / 3, 16 / 9, 0.1, 100.0)


def _ortho(m, rng):
    return m.mat4_ortho(-2.0, 3.0, -1.0, 4.0, 0.5, 60.0)


def _orbit(m, rng):
    q = rand_quat(rng, (4,))
    t = rng.standard_normal((4, 3)).astype(np.float32)
    return m.transform_orbit(*m_in(m, q, t), 5.0)


def _barycentric(m, rng):
    p1, p2, p3, pos = m_in(m, np.array([0.0, 1.0, 0.0], np.float32),
                           np.array([1.0, 3.0, 0.0], np.float32),
                           np.array([0.0, 4.0, 1.0], np.float32),
                           np.array([0.25, 0.25], np.float32))
    return m.barycentric(p1, p2, p3, pos)


def _axis_angle(m, rng):
    axis = rng.standard_normal((8, 3)).astype(np.float32)
    axis[0] = 0.0
    ang = rng.uniform(-3, 3, (8,)).astype(np.float32)
    return m.quat_from_axis_angle(*m_in(m, axis, ang))


def _vec(m, rng):
    a = rng.standard_normal((16, 3)).astype(np.float32)
    b = rng.standard_normal((16, 3)).astype(np.float32)
    ta, tb = m_in(m, a, b)
    return (m.cross(ta, tb), m.normalize(ta), m.normalize(ta * 0.0, eps=1e-6),
            m.length(ta), m.dot(ta, tb), m.lerp(ta, tb, 0.25),
            m.cos_interp(ta, tb, 0.25), m.smoothstep(-1.0, 1.0, ta))


def _mat4_builders(m, rng):
    q = rand_quat(rng, (8,))
    t = rng.standard_normal((8, 3)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, (8, 3)).astype(np.float32)
    v = rng.standard_normal((8, 4)).astype(np.float32)
    tq, tt, ts, tv = m_in(m, q, t, s, v)
    mm = m.mat4_mul(m.mat4_translate(tt),
                    m.mat4_mul(m.mat4_from_quat(tq), m.mat4_scale_aniso(ts)))
    return (m.qidentity((3,)) + 0.0, m.qconj(tq), mm,
            m.mat4_mul_vec4(mm, tv))


CASES = {
    "qmul": _qmul, "mat4_builders": _mat4_builders, "qrot": _qrot, "mat3_from_quat": _mat3,
    "quat_from_mat3": _quat_from_mat3, "euler": _euler, "slerp": _slerp,
    "compose_trs_inverse": _trs, "view_matrix": _view, "look_at": _look_at,
    "perspective": _perspective, "ortho": _ortho, "orbit": _orbit,
    "barycentric": _barycentric, "axis_angle": _axis_angle, "vec3": _vec,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mathx_matches_jax(case):
    fn = CASES[case]
    ref = fn(jmx, np.random.default_rng(0))
    got = fn(tmx, np.random.default_rng(0))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        g = g.numpy()
        assert r.shape == g.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=0)
