"""The port's raster core against the JAX package: record builders and
coefficient records, bin_triangles (exact: the same stable depth-ordered
sort), and the plain versions of K1 / K2 (raster_tile_ref,
raster_depth_ref) against the Pallas kernels in interpret mode
(_raster_main / rasterize_depth) and against raster_brute. Bars: binning
exact; planes — tid agreement >= 99.5 % and depth within 1e-4 where ids
agree. The CUDA kernels themselves are held against the plain versions
on the card by tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clap_tpu import mathx as jmx
from clap_tpu.render import raster as JR
from clap_tpu.render.view import cascade_subviews as jcascades
from clap_tpu.scene.terrain import terrain_init_square_landscape
from clap_tpu_torch.render import raster as TR


def _scene(W, H, eye=(6.0, 6.0, 6.0), n=24):
    """The kernel_parity_check terrain (bench.py:780-803) in clip space."""
    t = terrain_init_square_landscape(5, -8.0, 0.0, -8.0, 16.0, n)
    verts = jnp.asarray(t.vx)
    faces = jnp.asarray(t.idx.reshape(-1, 3))
    view = jmx.mat4_look_at(jnp.asarray(eye), jnp.zeros(3),
                            jnp.array([0.0, 1.0, 0.0]))
    proj = jmx.mat4_perspective(jnp.pi / 3, W / H, 0.1, 50.0)
    clip = jnp.einsum("ij,vj->vi", proj @ view, jnp.concatenate(
        [verts, jnp.ones_like(verts[:, :1])], -1))
    return clip, faces, t


def _records(W, H):
    clip, faces, _ = _scene(W, H)
    sx, sy, z, iw = JR.project_to_screen(clip, W, H)
    return JR.assemble_tri_records(sx, sy, z, iw, faces,
                                   jnp.ones((faces.shape[0],), bool))


def _atlas_records(s=64, n_casc=4):
    """A 4-cascade two-sided depth atlas (C·s, s), built the way
    shadow_pass_all builds it, with each cascade's band id."""
    _, faces, t = _scene(s, s)
    verts = jnp.asarray(t.vx)
    cam_view = jmx.mat4_look_at(jnp.array([7.0, 5.0, 7.0]), jnp.zeros(3),
                                jnp.array([0.0, 1.0, 0.0]))
    cam_proj = jmx.mat4_perspective(jnp.pi / 3, 1.0, 0.1, 60.0)
    casc, _ = jcascades(cam_view, cam_proj, jnp.array([-0.4, -0.8, -0.4]),
                        0.1, 60.0)
    T = faces.shape[0]
    pad = (-T) % JR.CLUSTER
    faces = jnp.concatenate([faces, jnp.zeros((pad, 3), faces.dtype)])
    valid = jnp.concatenate([jnp.ones((T,), bool), jnp.zeros((pad,), bool)])
    V = verts.shape[0]
    cols = [[], [], [], []]
    for c in range(n_casc):
        clip = jnp.einsum("ij,vj->vi", casc.proj[c] @ casc.view[c],
                          jnp.concatenate([verts, jnp.ones((V, 1))], -1))
        sx, sy, z, iw = JR.project_to_screen(clip, s, s)
        for k, v in enumerate((sx, sy + c * s, z, iw)):
            cols[k].append(v)
    sx, sy, z, iw = (jnp.concatenate(c) for c in cols)
    allf = jnp.concatenate([faces + c * V for c in range(n_casc)])
    rec, ok = JR.assemble_tri_records(sx, sy, z, iw, allf,
                                      jnp.concatenate([valid] * n_casc),
                                      two_sided=True)
    band = jnp.repeat(jnp.arange(n_casc, dtype=jnp.int32), T + pad)
    return rec, ok, band


def _t(x):
    return torch.as_tensor(np.array(x))


def _bin_both(rec, ok, W, H, **kw):
    jb = JR.bin_triangles(rec, ok, W, H, **kw)
    tkw = dict(kw)
    if "band_id" in tkw:
        tkw["band_id"] = _t(tkw["band_id"])
    tb = TR.bin_triangles(_t(rec)[None], _t(ok)[None], W, H, **tkw)
    return jb, tb


# --------------------------------------------------------------- records

def _clip_case(tid_pack, extras):
    """A camera inside the terrain's bbox: near-plane crossing triangles."""
    clip, faces, t = _scene(128, 128, eye=(1.0, 1.5, 1.0))
    T = faces.shape[0]
    normals = jnp.asarray(t.norm)
    pack = jnp.asarray(np.arange(T, dtype=np.int32) % 5) if tid_pack \
        else None
    jr = JR.clip_near_records(clip, faces, 128, 128,
                              jnp.ones((T,), bool),
                              vextra=normals if extras else None,
                              tid_pack=pack, pack_stride=8)
    tr = TR.clip_near_records(_t(clip)[None], _t(faces), 128, 128,
                              torch.ones((1, T), dtype=torch.bool),
                              vextra=_t(normals)[None] if extras else None,
                              tid_pack=None if pack is None else _t(pack),
                              pack_stride=8)
    return jr, tr


@pytest.mark.parametrize("case", ["tri13", "clip19", "clip22_packed",
                                  "two_sided"])
def test_records_and_coeffs(case):
    if case in ("tri13", "two_sided"):
        clip, faces, _ = _scene(128, 128)
        two = case == "two_sided"
        sx, sy, z, iw = JR.project_to_screen(clip, 128, 128)
        jrec, jok = JR.assemble_tri_records(
            sx, sy, z, iw, faces, jnp.ones((faces.shape[0],), bool),
            two_sided=two)
        ts = TR.project_to_screen(_t(clip)[None], 128, 128)
        trec, tok = TR.assemble_tri_records(
            *ts, _t(faces), torch.ones((1, faces.shape[0]), dtype=torch.bool),
            two_sided=two)
    else:
        (jrec, jok, _, _), (trec, tok, _, _) = _clip_case(
            case == "clip22_packed", case == "clip22_packed")
    np.testing.assert_array_equal(tok[0].numpy(), np.asarray(jok))
    scale = np.maximum(np.abs(np.asarray(jrec)), 1.0)
    np.testing.assert_allclose(trec[0].numpy() / scale,
                               np.asarray(jrec) / scale, atol=1e-5, rtol=0)
    jrec = JR._pad_cluster(jrec, jok, None, 8)[0]
    for jfn, tfn in ((JR.records_to_coeffs, TR.records_to_coeffs),
                     (JR.records_to_coeffs_depth,
                      TR.records_to_coeffs_depth)):
        a = np.asarray(jfn(jrec, 8))
        b = tfn(_t(jrec)[None], 8)[0].numpy()
        assert a.shape == b.shape
        fin = np.isfinite(a)
        np.testing.assert_array_equal(np.isfinite(b), fin)
        sc = np.maximum(np.abs(a[fin]), 1.0)
        np.testing.assert_allclose(b[fin] / sc, a[fin] / sc, atol=1e-5,
                                   rtol=0)


# --------------------------------------------------------------- binning

BIN_CASES = {
    "128x128": (128, 128, {}),
    "256x128": (256, 128, {}),
    "128x128_tile_at_cap": (128, 128, {"cap": 64}),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES) + ["cascade_atlas"])
def test_bin_triangles_exact(case):
    if case == "cascade_atlas":
        rec, ok, band = _atlas_records()
        th, tw = JR.tile_dims(64, 256)
        jb, tb = _bin_both(rec, ok, 64, 256, band_id=band,
                           band_tiles=64 // th, tile_h=th, tile_w=tw)
    else:
        W, H, kw = BIN_CASES[case]
        rec, ok = _records(W, H)
        jb, tb = _bin_both(rec, ok, W, H, **kw)
    for name, a, b in zip(("tile_list", "counts", "big_idx", "big_count"),
                          jb, tb):
        np.testing.assert_array_equal(b[0].numpy(), np.asarray(a),
                                      err_msg=name)
    if case == "128x128_tile_at_cap":
        stats = TR.bin_stats(tb)
        assert stats["tiles_at_cap"] >= 1


# ------------------------------------------------------ K1 / K2 plain versions

def _tile_agreement(j_planes, t_planes):
    jd, jt = (np.asarray(p) for p in j_planes[:2])
    td, tt = (p[0].numpy() for p in t_planes[:2])
    same = jt == tt
    hit = same & (jt >= 0)
    return same.mean(), (np.abs(jd[hit] - td[hit]).max() if hit.any()
                         else 0.0)


RASTER_CASES = [("128x128", 32), ("256x128", 8), ("256x128", 16),
                ("256x128", 32), ("128x128_tile_at_cap", 32)]


@pytest.mark.parametrize("case,chunk", RASTER_CASES)
def test_raster_tile_ref_matches_jax_kernel(case, chunk):
    W, H, kw = BIN_CASES[case]
    rec, ok = _records(W, H)
    jb, tb = _bin_both(rec, ok, W, H, **kw)
    jp = JR._raster_main(rec, jb, W, H, None, None, 8, chunk)
    tp = TR._raster_main(_t(rec)[None], tb, W, H, None, None, 8, chunk)
    agree, derr = _tile_agreement(jp, tp)
    assert agree >= 0.995
    assert derr <= 1e-4
    # attribute planes where ids agree (scaled: d0/d1/s ∝ 1/w)
    same = np.asarray(jp[1]) == tp[1][0].numpy()
    for i in (2, 3, 4):
        a = np.asarray(jp[i])[same]
        b = tp[i][0].numpy()[same]
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("case", ["128x128", "256x128", "cascade_atlas"])
def test_raster_depth_ref_matches_jax_kernel(case):
    if case == "cascade_atlas":
        rec, ok, band = _atlas_records()
        W, H = 64, 256
        th, tw = JR.tile_dims(W, H)
        kw = dict(band_id=band, band_tiles=64 // th, tile_h=th, tile_w=tw)
        jb, tb = _bin_both(rec, ok, W, H, **kw)
        jd = JR.rasterize_depth(rec, jb, W, H, th, tw)
        td = TR.rasterize_depth(_t(rec)[None], tb, W, H, th, tw)
    else:
        W, H, kw = BIN_CASES[case]
        rec, ok = _records(W, H)
        jb, tb = _bin_both(rec, ok, W, H)
        jd = JR.rasterize_depth(rec, jb, W, H)
        td = TR.rasterize_depth(_t(rec)[None], tb, W, H)
    a, b = np.asarray(jd), td[0].numpy()
    fa, fb = np.isfinite(a), np.isfinite(b)
    assert (fa == fb).mean() >= 0.995
    both = fa & fb
    assert both.any()
    assert np.abs(a[both] - b[both]).max() <= 1e-4


@pytest.mark.parametrize("case", ["128x128", "256x128"])
def test_raster_ref_matches_brute_oracle(case):
    W, H, _ = BIN_CASES[case]
    clip, faces, _ = _scene(W, H)
    ts = TR.project_to_screen(_t(clip)[None], W, H)
    rec, ok = TR.assemble_tri_records(
        *ts, _t(faces), torch.ones((1, faces.shape[0]), dtype=torch.bool))
    gb = TR.rasterize(rec, TR.bin_triangles(rec, ok, W, H), W, H)
    ref = TR.raster_brute(rec[0], ok[0], W, H)
    jref = JR.raster_brute(jnp.asarray(rec[0].numpy()),
                           jnp.asarray(ok[0].numpy()), W, H)
    np.testing.assert_array_equal(ref.tri_id.numpy(), np.asarray(jref.tri_id))
    same = gb.tri_id[0] == ref.tri_id
    assert float(same.float().mean()) >= 0.995
    hit = same & (ref.tri_id >= 0)
    assert float((gb.depth[0] - ref.depth).abs()[hit].max()) <= 1e-4
    # face barycentrics agree with the oracle where ids agree
    np.testing.assert_allclose(gb.bary[0][hit].numpy(),
                               ref.bary[hit].numpy(), atol=2e-3)


def test_compact_faces_matches_jax():
    """Valid-first cluster compaction: per env, the same kept faces in the
    same (stream) order as the JAX package."""
    rng = np.random.default_rng(3)
    T = 203                                      # not a cluster multiple
    faces = rng.integers(0, 500, (T, 3)).astype(np.int32)
    extra = np.arange(T, dtype=np.int32)
    valid = rng.uniform(size=(2, T)) < 0.3
    got = TR.compact_faces(_t(faces), _t(valid), 64, extra=_t(extra))
    for b in range(2):
        ref = JR.compact_faces(jnp.asarray(faces), jnp.asarray(valid[b]), 64,
                               extra=jnp.asarray(extra))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))


def test_corner_records_matches_jax():
    rng = np.random.default_rng(4)
    c = rng.uniform(-1, 1, (3, 40, 4)).astype(np.float32)
    c[..., 0:2] = c[..., 0:2] * 64 + 64          # screen x, y
    c[..., 3] = np.abs(c[..., 3]) + 0.1          # 1/w > 0
    for two in (False, True):
        jrec, jok = JR.corner_records(*(jnp.asarray(x) for x in c),
                                      two_sided=two)
        trec, tok = TR.corner_records(*(_t(x) for x in c), two_sided=two)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(trec.numpy(), np.asarray(jrec))


def _kernel_args_list(depth_only=False):
    rec, ok = _records(128, 128)
    trec = _t(rec)[None]
    return list(TR.kernel_inputs(trec, TR.bin_triangles(
        trec, _t(ok)[None], 128, 128), 128, 128, depth_only=depth_only))


def test_kernel_inputs_reject_bad_chunk():
    args = _kernel_args_list()
    args[-2] = 24                      # does not divide the big-list size
    with pytest.raises(ValueError):
        TR._kernel_args(*args, TR.NCOEF)


@pytest.mark.parametrize("chunk", [12, 4, 40])
def test_kernel_args_reject_chunk_not_whole_clusters(chunk):
    """A chunk is whole cluster rows (8 records) of at most 32 records."""
    args = _kernel_args_list(depth_only=True)
    assert args[-1] == 8
    args[-2] = chunk
    with pytest.raises(ValueError, match="whole cluster rows"):
        TR._kernel_args(*args, TR.NCOEF_DEPTH)


def test_kernel_inputs_build_no_per_tile_copy():
    """kernel_inputs hands the kernels the coefficient cluster rows and the
    binning's own id lists: nothing (B, n_tiles, sub·cap, NC) is built."""
    rec, ok = _records(256, 128)
    trec = _t(rec)[None]
    binned = TR.bin_triangles(trec, _t(ok)[None], 256, 128)
    crec, tile_list, big_idx, counts, *rest = TR.kernel_inputs(
        trec, binned, 256, 128)
    assert crec.shape == (1, TR.cdiv(trec.shape[-1], 8), 8 * TR.NCOEF)
    assert torch.equal(tile_list, binned[0])
    assert torch.equal(big_idx, binned[2])
    assert counts.shape == (1, 8, 3) and list(rest[-3:]) == [2, 32, 8]
