"""The PyTorch port imports no JAX, and its kernel wrappers take their
plain versions only because the tensors they get lie on the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import clap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(clap_tpu_torch.__path__,
                                                 'clap_tpu_torch.')]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')
             or k == 'clap_tpu' or k.startswith('clap_tpu.'))
print(len(names), bad)
assert not bad, bad
assert 'jax' not in sys.modules
"""


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    n, bad = r.stdout.strip().split(" ", 1)
    assert int(n) >= 86 and bad == "[]"


@pytest.mark.parametrize("module", ["clap_tpu_torch.render.charskin",
                                    "clap_tpu_torch.render.texture",
                                    "clap_tpu_torch.engine.frame"])
def test_skinned_and_textured_modules_import_no_jax(module):
    """The modules of the skinned and textured frame, each on its own."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'clap_tpu')]; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("module", ["clap_tpu_torch.render.post",
                                    "clap_tpu_torch.render.pipeline",
                                    "clap_tpu_torch.render.raster",
                                    "clap_tpu_torch.physics.world",
                                    "clap_tpu_torch.engine.state",
                                    "clap_tpu_torch.bridge"])
def test_frame_batch_and_host_flag_modules_import_no_jax(module):
    """The modules of the corner streams, the shared-scene batch, the
    bilinear upsample and the host-side body flags, each on its own."""
    test_skinned_and_textured_modules_import_no_jax(module)


@pytest.mark.parametrize("module", ["clap_tpu_torch.ops.noise",
                                    "clap_tpu_torch.render.lut",
                                    "clap_tpu_torch.ops.particles",
                                    "clap_tpu_torch.render.shade",
                                    "clap_tpu_torch.render.scenerender",
                                    "clap_tpu_torch.engine.frame"])
def test_option_and_game_frame_modules_import_no_jax(module):
    """The modules of the render options and of the game's own frame
    (device noise, LUTs, billboards, PCF, single-env assembly,
    GameFrameRenderer), each on its own."""
    test_skinned_and_textured_modules_import_no_jax(module)


AUTHORED_LEVEL = ["clap_tpu_torch.utils.png", "clap_tpu_torch.scene.gltf",
                  "clap_tpu_torch.scene.loader", "clap_tpu_torch.scene.content",
                  "clap_tpu_torch.scene.editor", "clap_tpu_torch.scene.assets57",
                  "clap_tpu_torch.char.motion", "clap_tpu_torch.engine.input",
                  "clap_tpu_torch.render.passbrowser"]


def test_authored_level_modules_import_no_jax():
    """The modules of the authored-level path (the PNG codec, glTF, the
    loader, content, the editor, the level's asset pack, motion, input and
    the pass browser's data) in one process, JAX and the JAX package
    looked for after each import."""
    code = ("import importlib, sys\n"
            f"for m in {AUTHORED_LEVEL!r}:\n"
            "    importlib.import_module(m)\n"
            "    bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'clap_tpu')]\n"
            "    assert not bad, (m, bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


ENGINE_SHELL = ["clap_tpu_torch.utils.bus", "clap_tpu_torch.utils.logger",
                "clap_tpu_torch.utils.profiler",
                "clap_tpu_torch.utils.settings",
                "clap_tpu_torch.utils.websocket",
                "clap_tpu_torch.utils.telemetry",
                "clap_tpu_torch.utils.guards",
                "clap_tpu_torch.utils.checkpoint", "clap_tpu_torch.utils.ogg",
                "clap_tpu_torch.utils.sound", "clap_tpu_torch.utils.librarian",
                "clap_tpu_torch.engine.fuzzer", "clap_tpu_torch.engine.core",
                "clap_tpu_torch.render.display", "clap_tpu_torch.demo",
                "clap_tpu_torch.demo.testbed"]


def test_engine_shell_modules_import_no_jax():
    """The engine shell, the host rim and the testbed demo in one process,
    JAX and the JAX package looked for after each import."""
    code = ("import importlib, sys\n"
            f"for m in {ENGINE_SHELL!r}:\n"
            "    importlib.import_module(m)\n"
            "    bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'clap_tpu')]\n"
            "    assert not bad, (m, bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


UI_AND_DEMOS = ["clap_tpu_torch.render.font", "clap_tpu_torch.render.ui",
                "clap_tpu_torch.render.ui_anim",
                "clap_tpu_torch.render.debugui",
                "clap_tpu_torch.render.debug_draw",
                "clap_tpu_torch.ops.canvas",
                "clap_tpu_torch.demo.flythrough",
                "clap_tpu_torch.demo.platformer"]


@pytest.mark.parametrize("module", UI_AND_DEMOS)
def test_ui_and_demo_modules_import_no_jax_and_no_pil(module):
    """The UI, the debug overlay, the canvas and the two demos, each on
    its own: neither JAX nor the JAX package nor PIL is imported (the
    glyph atlas imports PIL only when it bakes)."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'clap_tpu', 'PIL')]; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


PARALLEL = ["clap_tpu_torch.parallel", "clap_tpu_torch.parallel.sharding",
            "clap_tpu_torch.parallel.multichip"]


@pytest.mark.parametrize("module", ["bench_torch", "clap_tpu_torch.bench",
                                    "chip_smoke"])
def test_bench_modules_import_no_jax(module):
    """The port's bench (the script and its module) and chip_smoke.py,
    which imports the bench's builders, each on its own in a process."""
    test_skinned_and_textured_modules_import_no_jax(module)


@pytest.mark.parametrize("module", PARALLEL)
def test_parallel_modules_import_no_jax(module):
    """Env-axis sharding and the sharded composed frame, each on its own."""
    test_skinned_and_textured_modules_import_no_jax(module)


# what of clap_tpu/ the port has no counterpart for, and why: the TPU's
# row selects and its Pallas launch of K3 (env-axis sharding is ported,
# clap_tpu_torch/parallel/)
NOT_PORTED = {
    "ops/gatherx.py": "the TPU row gather; the port indexes plainly",
    "ops/ca2d.py:on_tpu": "the TPU backend test",
    "ops/ca2d.py:ca2d_run_pallas": "the Pallas launch of K3; the port's "
                                   "kernel is ca2d_run_fused",
    "physics/heightfield.py:mxu_rows_2": "the one-hot matmul row select; "
                                         "the port indexes plainly",
}


def test_port_covers_every_module_and_public_function():
    """Every module of clap_tpu/ has its counterpart in clap_tpu_torch/
    with every public top-level function and class of the same name,
    but the TPU-only pieces of NOT_PORTED, and every public function of
    bench.py (the JAX bench) has its namesake in clap_tpu_torch/bench.py.
    The JAX package and bench.py are read as source, not imported."""
    code = ("import ast, importlib, json, sys\n"
            "from pathlib import Path\n"
            f"skip = {sorted(NOT_PORTED)!r}\n"
            "missing = []\n"
            "for f in sorted(Path('clap_tpu').rglob('*.py')):\n"
            "    rel = f.relative_to('clap_tpu').as_posix()\n"
            "    if f.name == '__init__.py' or rel in skip:\n"
            "        continue\n"
            "    mod = 'clap_tpu_torch.' + rel[:-3].replace('/', '.')\n"
            "    try:\n"
            "        m = importlib.import_module(mod)\n"
            "    except ImportError:\n"
            "        missing.append(rel)\n"
            "        continue\n"
            "    for n in ast.parse(f.read_text()).body:\n"
            "        if isinstance(n, (ast.FunctionDef, ast.ClassDef)) \\\n"
            "                and not n.name.startswith('_') \\\n"
            "                and f'{rel}:{n.name}' not in skip \\\n"
            "                and not hasattr(m, n.name):\n"
            "            missing.append(f'{rel}:{n.name}')\n"
            "bench = importlib.import_module('clap_tpu_torch.bench')\n"
            "for n in ast.parse(Path('bench.py').read_text()).body:\n"
            "    if isinstance(n, ast.FunctionDef) \\\n"
            "            and not n.name.startswith('_') \\\n"
            "            and not hasattr(bench, n.name):\n"
            "        missing.append(f'bench.py:{n.name}')\n"
            "assert not [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'clap_tpu')]\n"
            "print(json.dumps(missing))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_testbed_demo_runs_without_jax():
    """``python -m clap_tpu_torch.demo.testbed`` at a cut size on the CPU,
    with no JAX in the process."""
    code = ("import sys; from clap_tpu_torch.demo import testbed as d; "
            "d.main(['--device', 'cpu', '--frames', '2', '--fuzzer'], "
            "scene=dict(nr_v=12, side=16.0, max_entities=32)); "
            "assert not [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'clap_tpu')]")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "frames: 2" in r.stdout


def test_asset_pack_builds_without_jax():
    """The level's glTF documents (the crate's PNG included) are made with
    no JAX in the process."""
    code = ("import sys; from clap_tpu_torch.scene.assets57 import "
            "asset_loader; "
            "assert b'image/png' in asset_loader('crate.gltf'); "
            "assert not [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'clap_tpu')]")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_committed_tables_load_without_jax():
    """The JAX package's PRNG tables are read from the committed file, with
    no JAX in the process."""
    code = ("import sys; from clap_tpu_torch.ops.noise import jax_table; "
            "assert jax_table('ssao_kernel').shape == (16, 3); "
            "assert jax_table('blue_noise2d').shape == (64, 64, 3); "
            "assert 'jax' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_imports_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|clap_tpu)\b", src,
                         re.MULTILINE)


@pytest.mark.parametrize("script", ["tools/torch_profile_frame.py",
                                    "tools/torch_raster_ab.py",
                                    "tools/torch_ca2d_ab.py",
                                    "tools/torch_server.py",
                                    "tools/torch_packer.py",
                                    "tools/torch_smoke_phases.py"])
def test_card_tools_import_no_jax(script):
    """The tools that run on the card (which has no JAX)."""
    src = (REPO / script).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|clap_tpu)\b", src,
                         re.MULTILINE)


def test_smoke_phases_tool_refuses_without_a_card():
    """tools/torch_smoke_phases.py runs chip_smoke.py's phases on a card
    only: without one it prints no result and exits 2."""
    r = subprocess.run([sys.executable, "tools/torch_smoke_phases.py", "18"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and not r.stdout
    assert "CUDA card" in r.stderr


def test_kernel_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    from clap_tpu_torch.render import raster as R

    counts = torch.zeros((1, 1, 2), dtype=torch.int32)
    tile_list = torch.zeros((1, 1, 4), dtype=torch.int32)
    big_idx = torch.zeros((1, 4), dtype=torch.int32)
    before = R.raster_tile.launches
    depth, tid, d0, d1, s = R.raster_tile(
        torch.zeros((1, 4, 8 * R.NCOEF)), tile_list, big_idx, counts, 128, 8,
        8, 128, 1, 32, 8)
    assert R.raster_tile.launches == before
    assert torch.isinf(depth).all() and (tid == -1).all()
    before = R.raster_depth.launches
    d = R.raster_depth(torch.zeros((1, 4, 8 * R.NCOEF_DEPTH)), tile_list,
                       big_idx, counts, 128, 8, 8, 128, 1, 32, 8)
    assert R.raster_depth.launches == before
    assert torch.isinf(d).all()


def test_ca2d_wrapper_counts_only_kernel_launches():
    from clap_tpu_torch.ops import ca2d

    before = ca2d.ca2d_run_fused.launches
    g = torch.zeros((2, 8, 8), dtype=torch.uint8)
    g[:, 3:5, 3:5] = 4
    out = ca2d.ca2d_run_fused(ca2d.CA_TEST, g, 2)
    assert ca2d.ca2d_run_fused.launches == before
    assert torch.equal(out, ca2d.ca2d_run(ca2d.CA_TEST, g, 2))
