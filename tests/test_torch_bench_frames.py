"""The port's bench (clap_tpu_torch/bench.py) against bench.py's own
``bench_full_frame`` on the CPU, at 256 × 128 with 24² terrain verts (the
default frame here, the dense form in tests/test_torch_bench_dense.py).
Their content fields are exact: the triangle count, the tiles at the
binning cap, the largest tile list and the nudged camera's
``input_dependent``. (The times are a CPU's, compared with nothing.)"""
from clap_tpu_torch import bench as port
from test_torch_common import jax_bench

FIELDS = ("metric", "tris", "tiles_at_cap", "max_per_tile",
          "input_dependent")


def content_of_both(tmp_path, **kw):
    """bench_full_frame's content fields from both packages at 256 × 128,
    24² terrain verts and ``kw``: (bench.py's, the port's)."""
    kw = dict(width=256, height=128, nr_v=24, **kw)
    ref = jax_bench(tmp_path, "bench_full_frame", **kw)
    got = port.bench_full_frame(**kw, device="cpu")
    ref = ref()
    assert got["value"] > 0 and got["device_busy_ms"] is None
    assert got["input_dependent"] is True
    return {f: ref[f] for f in FIELDS}, {f: got[f] for f in FIELDS}


def test_full_frame_content_matches_bench_py(tmp_path):
    ref, got = content_of_both(tmp_path)
    assert got == ref
