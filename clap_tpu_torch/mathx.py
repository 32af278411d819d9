"""Vector / quaternion / mat4 math (counterpart of clap_tpu/mathx.py).

Re-provides the semantics of the reference's linmath.h and transform.c as
torch functions that broadcast over arbitrary leading batch axes, with the
JAX package's conventions:

- Quaternions are ``[x, y, z, w]`` Hamilton quaternions.
- Matrices are ``(..., 4, 4)`` acting on column vectors: ``M @ v``;
  translation lives in ``M[..., :3, 3]``.
- Euler angles follow quat_from_euler_xyz (linmath.h:856-870).

Every function runs on the device (and dtype) of its tensor inputs;
python-number arguments are promoted to float32 tensors.
"""
from __future__ import annotations

import math

import torch


def _t(x, like=None):
    """Tensor view of ``x`` (float32 unless ``x`` already is a tensor)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _frozen(v):
    return tuple(_frozen(x) for x in v) if isinstance(v, (list, tuple)) \
        else v


# const's tensors by (values, dtype, device); tests read it to check that
# no caller wrote into one
CONSTS = {}


def const(values, device=None, dtype=torch.float32):
    """The constant tensor of ``values`` (a number or nested sequence) on
    ``device``, copied from the host once per (values, dtype, device) and
    kept: per-frame code reads it with no host-to-device copy after its
    first call. Never modify it in place. For the few fixed values of the
    frame code (axes, defaults, options), not for data."""
    key = (_frozen(values), dtype, torch.device(device or "cpu"))
    t = CONSTS.get(key)
    if t is None:
        t = CONSTS[key] = torch.tensor(key[0], dtype=dtype, device=key[2])
    return t


def f32(x, device=None):
    """``x`` as a float32 tensor on ``device``: a tensor as it is, a
    number as a ``const``."""
    return x.to(torch.float32) if isinstance(x, torch.Tensor) \
        else const(x, device)


# ---------------------------------------------------------------------------
# vec3 helpers
# ---------------------------------------------------------------------------

def dot(a, b, axis=-1, keepdims=False):
    return torch.sum(a * b, dim=axis, keepdim=keepdims)


def length(v, axis=-1, keepdims=False):
    return torch.sqrt(torch.sum(v * v, dim=axis, keepdim=keepdims))


def normalize(v, eps=0.0):
    """vec*_norm: v / |v|. With eps>0, returns 0 for near-zero vectors."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    if eps:
        big = n2 > eps * eps
        safe = torch.where(big, n2, torch.ones_like(n2))
        return torch.where(big, v / torch.sqrt(safe), torch.zeros_like(v))
    return v / torch.sqrt(n2)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def clamp(x, lo, hi):
    return torch.clamp(x, lo, hi)


def lerp(a, b, t):
    """lin*_interp (interp.h DEFINE_LIN_INTERP)."""
    return a * (1.0 - t) + b * t


def cos_interp(a, b, t):
    """cosf_interp (interp.h DEFINE_COS_INTERP)."""
    f = (1.0 - torch.cos(_t(t, a) * math.pi)) / 2.0
    return a * (1.0 - f) + b * f


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def barycentric(p1, p2, p3, pos):
    """Height interpolation inside a triangle (interp.h:49)."""
    det = (p2[..., 2] - p3[..., 2]) * (p1[..., 0] - p3[..., 0]) + (
        p3[..., 0] - p2[..., 0]
    ) * (p1[..., 2] - p3[..., 2])
    l1 = (
        (p2[..., 2] - p3[..., 2]) * (pos[..., 0] - p3[..., 0])
        + (p3[..., 0] - p2[..., 0]) * (pos[..., 1] - p3[..., 2])
    ) / det
    l2 = (
        (p3[..., 2] - p1[..., 2]) * (pos[..., 0] - p3[..., 0])
        + (p1[..., 0] - p3[..., 0]) * (pos[..., 1] - p3[..., 2])
    ) / det
    l3 = 1.0 - l1 - l2
    return l1 * p1[..., 1] + l2 * p2[..., 1] + l3 * p3[..., 1]


# ---------------------------------------------------------------------------
# quaternions — [x, y, z, w]
# ---------------------------------------------------------------------------

def qidentity(shape=(), dtype=torch.float32, device=None):
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)
    return q.expand(*shape, 4)


def qmul(p, q):
    """quat_mul (linmath.h:899-908): Hamilton product r = p*q."""
    px, py, pz, pw = (p[..., i] for i in range(4))
    qx, qy, qz, qw = (q[..., i] for i in range(4))
    return torch.stack(
        [
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
            pw * qw - px * qx - py * qy - pz * qz,
        ],
        dim=-1,
    )


def qconj(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def qrot(q, v):
    """quat_mul_vec3 (linmath.h:939-957): rotate v by q (ryg's method)."""
    qv = q[..., :3]
    t = 2.0 * cross(qv, v)
    return v + q[..., 3:4] * t + cross(qv, t)


def qnormalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_from_axis_angle(axis, angle):
    """quat_from_axis_angle (linmath.h:841-855). axis (...,3), angle (...)."""
    angle = _t(angle, axis)
    l2 = torch.sum(axis * axis, dim=-1)
    half = angle * 0.5
    pos = l2 > 0
    scale = torch.where(
        pos, torch.sin(half) / torch.sqrt(torch.where(pos, l2, 1.0)), 0.0)
    xyz = axis * scale[..., None]
    w = torch.where(pos, torch.cos(half), 1.0)
    xyz, w = torch.broadcast_tensors(xyz, w[..., None])
    return torch.cat([xyz, w[..., :1]], dim=-1)


def quat_from_euler_xyz(x, y, z):
    """quat_from_euler_xyz (linmath.h:856-870)."""
    cx, sx = torch.cos(x * 0.5), torch.sin(x * 0.5)
    cy, sy = torch.cos(y * 0.5), torch.sin(y * 0.5)
    cz, sz = torch.cos(z * 0.5), torch.sin(z * 0.5)
    return torch.stack(
        [
            sx * cy * cz - cx * sy * sz,
            cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz,
            cx * cy * cz + sx * sy * sz,
        ],
        dim=-1,
    )


def quat_to_euler_xyz(q):
    """quat_to_euler_xyz (linmath.h:871-887). Returns (x, y, z)."""
    qx, qy, qz, qw = (q[..., i] for i in range(4))
    x = torch.atan2(2.0 * (qw * qx + qy * qz), 1.0 - 2.0 * (qx * qx + qy * qy))
    sinp = 2.0 * (qw * qy - qz * qx)
    y = torch.where(
        torch.abs(sinp) >= 1.0,
        torch.sign(sinp) * (math.pi / 2.0),
        torch.asin(torch.clamp(sinp, -1.0, 1.0)),
    )
    z = torch.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
    return x, y, z


def qslerp(a, b, t):
    """Shortest-arc slerp with lerp fallback for near-parallel quats
    (model.c:1290-1342 channel rotation path)."""
    t = _t(t, a)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(d < 0, -b, b)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.acos(d)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    st = torch.where(use_lerp, 1.0, sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / st)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / st)
    return qnormalize(w0 * a + w1 * b)


def mat3_from_quat(q):
    """Rotation part of mat4x4_from_quat (linmath.h:959-991), (...,3,3)."""
    x, y, z, w = (q[..., i] for i in range(4))
    x2, y2, z2, w2 = x * x, y * y, z * z, w * w
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), w2 - x2 + y2 - z2, 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def quat_from_mat3(m):
    """Robust rotation-matrix → quaternion (Shepperd's method), branch-free:
    all four candidates, selected by the largest pivot."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(x, y, z, w):
        return torch.stack([x, y, z, w], dim=-1)

    sw = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 2.0
    qw = mk((m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, 0.25 * sw)
    sx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 2.0
    qx = mk(0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx)
    sy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 2.0
    qy = mk((m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy, (m02 - m20) / sy)
    sz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 2.0
    qz = mk((m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz, (m10 - m01) / sz)

    cond_w = tr > 0.0
    cond_x = (m00 > m11) & (m00 > m22)
    cond_y = m11 > m22
    q = torch.where(
        cond_w[..., None], qw,
        torch.where(cond_x[..., None], qx,
                    torch.where(cond_y[..., None], qy, qz)))
    return qnormalize(q)


# ---------------------------------------------------------------------------
# mat4 — (..., 4, 4), column-vector convention
# ---------------------------------------------------------------------------

def mat4_identity(shape=(), dtype=torch.float32, device=None):
    return torch.eye(4, dtype=dtype, device=device).expand(*shape, 4, 4)


def mat4_from_quat(q):
    """mat4x4_from_quat (linmath.h:959-991)."""
    m = mat4_identity(q.shape[:-1], q.dtype, q.device).clone()
    m[..., :3, :3] = mat3_from_quat(q)
    return m


def mat4_translate(v):
    m = mat4_identity(v.shape[:-1], v.dtype, v.device).clone()
    m[..., :3, 3] = v
    return m


def mat4_scale_aniso(s):
    """Diagonal scale; s is (...,3)."""
    m = mat4_identity(s.shape[:-1], s.dtype, s.device).clone()
    for i in range(3):
        m[..., i, i] = s[..., i]
    return m


def mat4_compose_trs(pos, rot_q, scale):
    """T * R * S as built by entity3d default_update (model.c:1670-1676).
    pos (...,3), rot_q (...,4), scale (...,) or (...,3)."""
    scale = _t(scale, pos)
    if scale.dim() == 0 or scale.shape[-1:] != (3,):
        scale = scale[..., None].expand(*scale.shape, 3)
    r = mat3_from_quat(rot_q) * scale[..., None, :]
    batch = torch.broadcast_shapes(pos.shape[:-1], r.shape[:-2])
    m = mat4_identity(batch, pos.dtype, pos.device).clone()
    m[..., :3, :3] = r
    m[..., :3, 3] = pos
    return m


def mat4_mul(a, b):
    return a @ b


def _mv(m, v):
    """(..., i, j) @ (..., j) with broadcasting batch dims."""
    return (m @ v[..., None])[..., 0]


def mat4_mul_vec4(m, v):
    return _mv(m, v)


def mat4_transform_point(m, p):
    """Apply mat4 to a (...,3) point (w=1)."""
    return _mv(m[..., :3, :3], p) + m[..., :3, 3]


def mat4_transform_dir(m, d):
    """Apply mat4 rotation/scale part to a (...,3) direction (w=0)."""
    return _mv(m[..., :3, :3], d)


def mat4_inverse_rigid(m):
    """Inverse of TRS matrices (explicit 3x3 inverse, so non-uniform scale
    also works — entity3d keeps inverse_mx for lighting, model.c:1677)."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    r_inv = torch.linalg.inv_ex(r).inverse
    m_out = mat4_identity(m.shape[:-2], m.dtype, m.device).clone()
    m_out[..., :3, :3] = r_inv
    m_out[..., :3, 3] = -_mv(r_inv, t)
    return m_out


def mat4_look_at(eye, center, up):
    """mat4x4_look_at (linmath.h): right-handed view matrix."""
    f = normalize(center - eye)
    s = normalize(cross(f, up))
    u = cross(s, f)
    batch = torch.broadcast_shapes(eye.shape[:-1], s.shape[:-1])
    m = mat4_identity(batch, eye.dtype, eye.device).clone()
    m[..., 0, :3] = s
    m[..., 1, :3] = u
    m[..., 2, :3] = -f
    m[..., 0, 3] = -dot(s, eye)
    m[..., 1, 3] = -dot(u, eye)
    m[..., 2, 3] = dot(f, eye)
    return m


def mat4_look_at_safe(eye, center, up):
    """mat4x4_look_at_safe (linmath.h:818-833): falls back to (0,0,-1) up
    when forward ~ parallel to up."""
    f = normalize(center - eye)
    dp = torch.abs(dot(f, normalize(up)))[..., None]
    alt = const([0.0, 0.0, -1.0], eye.device, eye.dtype)
    up_adj = torch.where(dp > 0.999, alt, up)
    return mat4_look_at(eye, center, up_adj)


def mat4_perspective(fovy, aspect, near, far, device=None):
    """GL-style perspective projection (linmath.h mat4x4_perspective),
    z in [-1, 1] NDC."""
    fovy, aspect, near, far = (f32(x, device)
                               for x in (fovy, aspect, near, far))
    a = 1.0 / torch.tan(fovy / 2.0)
    batch = torch.broadcast_shapes(fovy.shape, aspect.shape, near.shape,
                                   far.shape)
    m = torch.zeros((*batch, 4, 4), dtype=torch.float32, device=device)
    m[..., 0, 0] = a / aspect
    m[..., 1, 1] = a
    m[..., 2, 2] = -(far + near) / (far - near)
    m[..., 2, 3] = -2.0 * far * near / (far - near)
    m[..., 3, 2].fill_(-1.0)
    return m


def mat4_ortho(l, r, b, t, n, f):
    """GL-style orthographic projection (linmath.h mat4x4_ortho)."""
    dev = next((x.device for x in (l, r, b, t, n, f)
                if isinstance(x, torch.Tensor)), None)
    l, r, b, t, n, f = (f32(x, dev) for x in (l, r, b, t, n, f))
    batch = torch.broadcast_shapes(*(x.shape for x in (l, r, b, t, n, f)))
    m = torch.zeros((*batch, 4, 4), dtype=torch.float32, device=dev)
    m[..., 0, 0] = 2.0 / (r - l)
    m[..., 1, 1] = 2.0 / (t - b)
    m[..., 2, 2] = -2.0 / (f - n)
    m[..., 0, 3] = -(r + l) / (r - l)
    m[..., 1, 3] = -(t + b) / (t - b)
    m[..., 2, 3] = -(f + n) / (f - n)
    m[..., 3, 3].fill_(1.0)
    return m


# ---------------------------------------------------------------------------
# transform — pos + rotation quat (transform.{c,h})
# ---------------------------------------------------------------------------

def transform_view_mat4(pos, rot_q):
    """transform_view_mat4x4 (transform.c:131-138): R^T then translate by
    -pos — the camera view matrix from camera pos + orientation quat."""
    rt = mat3_from_quat(rot_q).transpose(-1, -2)
    batch = torch.broadcast_shapes(pos.shape[:-1], rt.shape[:-2])
    m = mat4_identity(batch, pos.dtype, pos.device).clone()
    m[..., :3, :3] = rt
    m[..., :3, 3] = -_mv(rt, pos)
    return m


def transform_orbit(rot_q, target, dist):
    """transform_orbit (transform.c:117-124): camera position at
    target + R*(0,0,dist)."""
    d = _t(dist, target)
    z = torch.zeros_like(d)
    start = torch.stack([z, z, d], dim=-1)
    return target + qrot(rot_q, start)
