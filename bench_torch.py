#!/usr/bin/env python3
"""The JAX bench's configurations on the PyTorch port, on one CUDA card:

    python3 bench_torch.py                  # all twelve, one JSON line each
    python3 bench_torch.py --device cpu     # bench.py's CPU rows
    python3 bench_torch.py --config KEY     # one config (the harness's child)

The last line of standard output is the merged result (bench.py's keys and
``device``); ``BENCH_BUDGET_S`` (default 1,500) caps the run's seconds. See
clap_tpu_torch/bench.py.
"""
import sys

from clap_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
