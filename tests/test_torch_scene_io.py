"""The port's host-side asset and input layers against the JAX package:
the PNG codec, the glTF parser (JSON and GLB documents, data URIs, BIN
chunks, strided views, matrix nodes (the port's Shepperd quaternion is
bit-exact here), materials, images, textures, skins, animations) and the collision-mesh convention, build_rig and
resolve_armature, the level's asset pack, InputRecord routing, and the
motion controller.

Exact (bytes, integers, parsed arrays) unless stated: record_to_inputs and
motion_get are float math, held within atol 1e-6 (a few float32 ulps of
unit-length vectors), and build_rig's float tables bit-exact."""
import base64
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "demo"))

import assets57
from clap_tpu.char import motion as jmotion
from clap_tpu.engine import input as jinput
from clap_tpu.scene import gltf as jgltf
from clap_tpu.utils import png as jpng
from clap_tpu_torch.char import motion as tmotion
from clap_tpu_torch.engine import input as tinput
from clap_tpu_torch.scene import assets57 as tassets
from clap_tpu_torch.scene import gltf as tgltf
from clap_tpu_torch.utils import png as tpng
from test_content import make_textured_gltf
from test_gltf import make_skinned_gltf


def _images():
    rng = np.random.default_rng(0)
    return {
        "gray": rng.integers(0, 256, (5, 7, 1), dtype=np.uint8),
        "rgb": rng.integers(0, 256, (9, 4, 3), dtype=np.uint8),
        "rgba": rng.integers(0, 256, (3, 11, 4), dtype=np.uint8),
        "float": rng.uniform(-0.2, 1.2, (6, 6, 3)).astype(np.float32),
        "2d": rng.integers(0, 256, (4, 5), dtype=np.uint8),
    }


def _filtered_png(ctype, nch, filters, plte=None, trns=None):
    """A PNG whose rows use the given filter types (0-4), built by hand so
    the decoder's Sub/Average/Paeth paths run."""
    rng = np.random.default_rng(len(filters) + ctype)
    h, w = len(filters), 5
    raw = rng.integers(0, 256, (h, w * nch), dtype=np.uint8)
    body = b"".join(bytes([f]) + raw[y].tobytes()
                    for y, f in enumerate(filters))

    def chunk(typ, payload):
        c = typ + payload
        return struct.pack(">I", len(payload)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("name", sorted(_images()))
def test_png_encode_and_decode_exact(name):
    img = _images()[name]
    data = tpng.encode_png(img)
    assert data == jpng.encode_png(img)
    np.testing.assert_array_equal(tpng.decode_png(data),
                                  jpng.decode_png(data))


@pytest.mark.parametrize("ctype,nch", [(0, 1), (2, 3), (3, 1), (4, 2),
                                       (6, 4)])
def test_png_decode_filters_exact(ctype, nch):
    plte = bytes(range(256)) * 3 if ctype == 3 else None
    trns = bytes(range(0, 256, 2)) if ctype == 3 else None
    data = _filtered_png(ctype, nch, [0, 1, 2, 3, 4, 4, 3, 1], plte, trns)
    got = tpng.decode_png(data)
    np.testing.assert_array_equal(got, jpng.decode_png(data))
    assert got.shape == (8, 5, 4)


def test_png_save(tmp_path):
    img = _images()["rgb"]
    tpng.save_png(tmp_path / "a.png", img)
    assert (tmp_path / "a.png").read_bytes() == jpng.encode_png(img)


def _glb(js: bytes, bin_chunk: bytes = b"") -> bytes:
    js = js + b" " * ((4 - len(js) % 4) % 4)
    out = struct.pack("<II", len(js), 0x4E4F534A) + js
    if bin_chunk:
        bin_chunk = bin_chunk + b"\0" * ((4 - len(bin_chunk) % 4) % 4)
        out += struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk
    return struct.pack("<III", 0x46546C67, 2, 12 + len(out)) + out


def _bin_chunk_glb():
    """The skinned arm with every buffer in one GLB BIN chunk, the
    positions interleaved with the normals (a strided view), and the
    elbow node given as a column-major matrix."""
    raw = json.loads(make_skinned_gltf())
    bufs = [base64.b64decode(b["uri"].split(",", 1)[1])
            for b in raw["buffers"]]
    pos = np.frombuffer(bufs[0], np.float32).reshape(4, 3)
    nrm = np.frombuffer(bufs[1], np.float32).reshape(4, 3)
    inter = np.concatenate([pos, nrm], 1).astype(np.float32).tobytes()
    blob, views = b"", []
    for i, b in enumerate([inter] + bufs[2:]):
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(b)})
        if i == 0:
            views[-1]["byteStride"] = 24
        blob += b + b"\0" * ((4 - len(b) % 4) % 4)
    raw["buffers"] = [{"byteLength": len(blob)}]
    raw["bufferViews"] = views
    acc = raw["accessors"]
    acc[0]["bufferView"] = 0
    acc[1]["bufferView"] = 0
    acc[1]["byteOffset"] = 12
    for a in acc[2:]:
        a["bufferView"] -= 1
    c, s = np.cos(0.6), np.sin(0.6)
    m = np.array([[c, -s, 0, 0.5], [s, c, 0, 1.0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32) @ np.diag([2, 2, 2, 1])
    raw["nodes"][1] = {"name": "elbow", "matrix": m.T.reshape(-1).tolist()}
    return _glb(json.dumps(raw).encode(), blob)


def _with_collision(doc_json: str) -> str:
    raw = json.loads(doc_json)
    raw["meshes"].append({"name": "collision", "primitives": [
        {"attributes": {"POSITION": 0}, "indices": raw["meshes"][0][
            "primitives"][0]["indices"]}]})
    return json.dumps(raw)


DOCS = {
    "skinned_json": lambda: make_skinned_gltf(),
    "skinned_glb": lambda: _glb(make_skinned_gltf().encode()),
    "bin_chunk_glb": _bin_chunk_glb,
    "textured": lambda: make_textured_gltf(),
    "collision": lambda: _with_collision(make_skinned_gltf()),
    **{f"asset_{k}": (lambda k=k: assets57.asset_loader(k))
       for k in ("crate.gltf", "platform.gltf", "hero.gltf", "light.gltf")},
}


def _assert_same(a, b, path):
    """Exact equality of two parsed values (dataclasses field by field,
    arrays in value and dtype)."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__, path
        for f in a.__dataclass_fields__:
            _assert_same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("name", sorted(DOCS))
def test_load_gltf_exact(name):
    data = DOCS[name]()
    ref, got = jgltf.load_gltf(data), tgltf.load_gltf(data)
    _assert_same(ref, got, name)
    _assert_same(jgltf.find_collision_mesh(ref),
                 tgltf.find_collision_mesh(got), f"{name}.collision")


def test_glb_container_exact():
    data = _bin_chunk_glb()
    ref, got = jgltf.parse_glb(data), tgltf.parse_glb(data)
    assert ref[0] == got[0] and ref[1] == got[1]


@pytest.mark.parametrize("name", ["skinned_json", "bin_chunk_glb"])
def test_build_rig_and_armature_exact(name):
    ref_doc = jgltf.load_gltf(DOCS[name]())
    got_doc = tgltf.load_gltf(DOCS[name]())
    sk_r, lib_r, names_r, remap_r = jgltf.build_rig(ref_doc)
    sk_t, lib_t, names_t, remap_t = tgltf.build_rig(got_doc, device="cpu")
    assert names_r == names_t
    np.testing.assert_array_equal(remap_t, remap_r)
    for f, a in zip(sk_r._fields, sk_r):
        b = getattr(sk_t, f)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                          err_msg=f)
    for f, a in zip(lib_r._fields, lib_r):
        np.testing.assert_array_equal(np.asarray(getattr(lib_t, f)),
                                      np.asarray(a), err_msg=f)
    arm = {"head": "elbow", "foot_left": "root", "hand_left": "nosuch"}
    assert tgltf.resolve_armature(got_doc, arm, remap_t) \
        == jgltf.resolve_armature(ref_doc, arm, remap_r)


@pytest.mark.parametrize("name", ["crate.gltf", "platform.gltf",
                                  "hero.gltf", "light.gltf"])
def test_asset_pack_byte_identical(name):
    assert tassets.asset_loader(name) == assets57.asset_loader(name)


def test_asset_pack_box_mesh_exact():
    for a, b in zip(tassets._box_mesh(2.0, 0.2, 2.0),
                    assets57._box_mesh(2.0, 0.2, 2.0)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


KEYS = ["w", "s", "a", "d", "up", "down", "left", "right", "space", "shift",
        "tab", "escape", "enter", "f1", "q"]
AXES = ["axis0", "axis1", "axis2", "axis3", "button0", "button4", "axis9"]


def test_input_bindings_exact():
    assert tinput.KEY_BINDINGS == jinput.KEY_BINDINGS
    assert tinput.PAD_BINDINGS == jinput.PAD_BINDINGS
    assert [f.name for f in tinput.InputRecord.__dataclass_fields__.values()
            ] == [f.name for f in
                  jinput.InputRecord.__dataclass_fields__.values()]


def _records(seed: int, n: int):
    """Pairs of records (JAX, port) driven by the same seeded key and axis
    events."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rj, rt = jinput.InputRecord(), tinput.InputRecord()
        for k in rng.choice(KEYS, 4):
            p = bool(rng.integers(2))
            jinput.apply_key(rj, str(k), p)
            tinput.apply_key(rt, str(k), p)
        for a in rng.choice(AXES, 2):
            v = float(rng.uniform(-1, 1))
            jinput.apply_axis(rj, str(a), v)
            tinput.apply_axis(rt, str(a), v)
        rj.zoom = rt.zoom = float(rng.uniform(-0.5, 0.5))
        out.append((rj, rt))
    return out


def test_input_record_routing_exact():
    for rj, rt in _records(1, 40):
        assert vars(rj) == vars(rt)


@pytest.mark.parametrize("n_chars", [1, 3])
def test_record_to_inputs(n_chars):
    """record_to_inputs on seeded records: jump/dash exact, motion and the
    camera deltas within atol 1e-6."""
    rng = np.random.default_rng(2)
    for rj, rt in _records(3, 24):
        yaw = float(rng.uniform(-np.pi, np.pi))
        speed = float(rng.uniform(0.5, 3.0))
        ref = jinput.record_to_inputs(rj, yaw, speed, n_chars)
        got = tinput.record_to_inputs(rt, yaw, speed, n_chars, device="cpu")
        for f, a, b in zip(ref._fields, ref, got):
            a = np.asarray(a)
            b = b.numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, f
            if a.dtype == bool:
                np.testing.assert_array_equal(b, a, err_msg=f)
            else:
                np.testing.assert_allclose(b, a, atol=1e-6, rtol=0,
                                           err_msg=f)


def test_motion_compute_and_get():
    """motion_compute_ls and motion_get broadcast over a (B,) env axis:
    within atol 1e-6 of the JAX package on seeded sticks."""
    rng = np.random.default_rng(4)
    B = 64
    lr = rng.integers(0, 2, (4, B)).astype(bool)
    lx = np.where(rng.uniform(size=B) < 0.5, 0.0,
                  rng.uniform(-1, 1, B)).astype(np.float32)
    ly = rng.uniform(-1, 1, B).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    ref = jmotion.motion_compute_ls(*[jnp.asarray(x) for x in lr],
                                    jnp.asarray(lx), jnp.asarray(ly))
    got = tmotion.motion_compute_ls(*[torch.as_tensor(x) for x in lr],
                                    torch.as_tensor(lx), torch.as_tensor(ly))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    jq = jmotion.camera_yaw_quat(jnp.asarray(yaw))
    tq = tmotion.camera_yaw_quat(torch.as_tensor(yaw))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    ref = jmotion.motion_get(ref[0], ref[1], jq, jnp.float32(2.5))
    got = tmotion.motion_get(got[0], got[1], tq, 2.5)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
