"""The port's ``bench_full_frame`` in its dense form (cubes among the
terrain, raster_cap 4096) against bench.py's own on the CPU, at 256 × 128
with 24² terrain verts and 8 cubes: the content fields of
tests/test_torch_bench_frames.py exact."""
from test_torch_bench_frames import content_of_both


def test_dense_full_frame_content_matches_bench_py(tmp_path):
    ref, got = content_of_both(tmp_path, n_cubes=8, raster_cap=4096,
                               name="full_frame_720p_dense_ms")
    assert got == ref and got["tris"] > 1058
