"""The port's bench against bench.py's own ``bench_full_frame_production``
on the CPU (256 × 128, 24² terrain verts, 8 cubes, bench.py's 2,048²
bake). Exact: the triangle counts, the dynamic shadow triangles,
``kernel_attrs``, ``cluster_rec``, ``clusters_at_cap`` and
``input_dependent``."""
from clap_tpu_torch import bench as port
from test_torch_common import jax_bench


def test_production_content_matches_bench_py(tmp_path):
    kw = dict(width=256, height=128, nr_v=24, n_cubes=8)
    ref = jax_bench(tmp_path, "bench_full_frame_production", **kw)
    got = port.bench_full_frame_production(**kw, device="cpu")
    ref = ref()
    fields = ("metric", "tris", "dyn_shadow_tris", "kernel_attrs",
              "cluster_rec", "clusters_at_cap", "input_dependent")
    assert {f: got[f] for f in fields} == {f: ref[f] for f in fields}
    assert got["kernel_attrs"] and got["cluster_rec"]
    assert got["bake_warm_ms"] > 0 and got["bake_cold_ms"] > 0
