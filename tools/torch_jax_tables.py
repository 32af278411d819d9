#!/usr/bin/env python3
"""Regenerate the tables the PyTorch port takes from the JAX package's
PRNG, which torch cannot reproduce:

    python3 tools/torch_jax_tables.py [--check]

- ``ssao_kernel`` (16, 3): ``post.ssao_kernel(jax.random.PRNGKey(7))``,
  the default hemisphere samples of ``ssao_mode="kernel"``
  (clap_tpu/render/pipeline.py ``render_frame``);
- ``blue_noise2d`` (64, 64, 3): ``noise.blue_noise2d(64)`` on
  ``PRNGKey(0)``, the default film-grain texture (demo/testbed.py).

Writes them, float32, to clap_tpu_torch/data/jax_tables.npz. With
``--check`` it writes nothing and exits non-zero unless the committed
file holds exactly these values. Runs JAX on the CPU.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "clap_tpu_torch" / "data" / "jax_tables.npz"


def tables() -> dict:
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from clap_tpu.ops.noise import blue_noise2d
    from clap_tpu.render.post import ssao_kernel

    return {"ssao_kernel": np.asarray(ssao_kernel(jax.random.PRNGKey(7)),
                                      np.float32),
            "blue_noise2d": np.asarray(blue_noise2d(64), np.float32)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    t = tables()
    if args.check:
        with np.load(OUT) as z:
            same = sorted(z.files) == sorted(t) and all(
                np.array_equal(z[k], v) for k, v in t.items())
        print(f"{OUT.relative_to(REPO)}: "
              f"{'equal to' if same else 'DIFFERS from'} the JAX draws")
        return 0 if same else 1
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez(OUT, **t)
    print(f"wrote {OUT.relative_to(REPO)}: "
          + ", ".join(f"{k} {v.shape}" for k, v in t.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
