#!/usr/bin/env python3
"""K3 (clap_tpu_torch ops/ca2d.py ``ca2d_run_fused``) measured on one CUDA
card, with CUDA events:

    python3 tools/torch_ca2d_ab.py [--old CHECKOUT] [--reps N]

Prints the card (nvidia-smi name, power limit, max SM clock), the ptxas
lines of csrc/ca2d.cu (registers, spills), the card's cluster cap and
cudaOccupancyMaxActiveClusters per cluster size, a bit-exact check of
every route against the plain version ``ca2d_run``, then times:

- 1,000 ``cluster.sync()`` in one empty cluster, per cluster size;
- config #1 (one 256² CA_TEST grid × 1,000 generations) at every cluster
  size, and on the planner's route;
- the batch (1,024 × 256² × 100) on its two one-CTA-per-grid routes, two
  buffers (a cluster of 1) and one buffer with a saved row (in place), in
  the order A, B, B, A;
- single grids of 512² and 1,024² × 1,000 and 2,048² × 5 (the
  device-memory route).

With ``--old``, the checkout's own csrc/ca2d.cu (an earlier K3 whose C
``ca2d_launch`` takes in, out, B, H, W, steps, born, surv, nr_states,
decay, mode and stream: one CTA per grid, one byte per cell) is built beside
this tree's and timed against it on config #1 and the batch, in the order
old, new, new, old. The last line is a JSON object of every time.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip() \
        .splitlines()[0].strip()


def build_old(checkout: Path):
    """The earlier kernel from ``checkout``, built with this tree's flags."""
    from clap_tpu_torch import cuda_build

    src = checkout / "clap_tpu_torch" / "csrc" / "ca2d.cu"
    out = cuda_build.BUILD_DIR / "ca2d_old.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    p = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                        str(out), str(src)], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(out))
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.ca2d_launch.argtypes = [P, P, I, I, I, I, U, U, I, I, I, P]
    lib.ca2d_launch.restype = I
    return lib, (p.stdout + p.stderr).strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_ca2d_ab: no CUDA device", file=sys.stderr)
        return 2
    from clap_tpu_torch import cuda_build
    from clap_tpu_torch.ops import ca2d as CA

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize
    card = smi("name,power.limit")
    clock = smi("clocks.max.sm")
    print(f"card: {card}; max SM clock {clock}", flush=True)
    res = {"card": card, "clocks_max_sm": clock}

    cuda_build.build_all(("ca2d",))
    for line in cuda_build.build_info["ca2d"]["log"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    old = None
    if a.old is not None:
        old, log = build_old(a.old)
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas (old): {line.strip()}")
    lib = cuda_build.load_lib("ca2d")

    limit, cap, sms = CA.ca2d_card(dev)
    print(f"card for K3: {limit} B shared memory per block, cluster cap "
          f"{cap}, {sms} SMs", flush=True)
    res.update(smem_limit=limit, cluster_cap=cap, sms=sms)
    sizes = [cs for cs in (1, 2, 4, 8, 16) if cs <= cap]
    act = {}
    for cs in (1, 2, 4, 8, 16):
        p = CA.ca2d_plan(1, 256, 256, limit, 16, sms, cluster=cs)
        act[cs] = (lib.ca2d_active_clusters(0, cs, p.smem),
                   lib.ca2d_active_clusters(0, cs, limit))
    print(f"max active clusters per size (at config #1's band, at the "
          f"full {limit} B): {act}", flush=True)
    res["active_clusters"] = act

    def time_ms(fn, reps=a.reps):
        fn()
        sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        sync()
        return e0.elapsed_time(e1) / reps

    gen = torch.Generator(device=dev).manual_seed(3)

    def seed(shape):
        return CA.ca2d_seed(CA.CA_TEST, shape, generator=gen, device=dev)

    # ---------------------------------------------------- parity, all routes
    vnv = CA.CARule("vnv test", born_mask=0b0011, surv_mask=0b0101,
                    nr_states=7, decay=True, neigh="vnv")
    vn1 = CA.CARule("vn1 test", born_mask=0b0110, surv_mask=0b1100,
                    nr_states=3, decay=True, neigh="vn1")
    cases = [((1, 256, 256), 64, cs) for cs in sizes]
    cases += [((132, 37, 53), 9, None), ((132, 96, 160), 17, None),
              ((8, 256, 256), 20, None), ((2, 37, 53), 9, None),
              ((1, 512, 512), 3, None), ((1, 1024, 1024), 3, None),
              ((1, 2048, 2048), 5, None)]
    for shape, steps, cs in cases:
        for rule in (CA.CA_TEST, CA.CA_COOL_TREE, CA.CA_ASH_PINUS, vn1, vnv):
            g = torch.randint(0, rule.nr_states + 1, shape, generator=gen,
                              device=dev, dtype=torch.int32).to(torch.uint8)
            plan = CA.ca2d_plan(*shape, limit, cap, sms, cluster=cs)
            k = CA.ca2d_run_fused(rule, g, steps, plan)
            sync()
            ok = torch.equal(k, CA.ca2d_run(rule, g, steps))
            if not ok:
                raise RuntimeError(f"not bit-exact: {rule.name} {shape} x "
                                   f"{steps} on {plan}")
        print(f"parity {shape} x {steps}: {plan.route} route, cluster "
              f"{plan.cluster}, run {plan.run}: bit-exact for 5 rules",
              flush=True)

    # ------------------------------------------------------------- timing
    bar = {}
    for cs in sizes:
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def probe(cs=cs, stream=stream):
            rc = lib.ca2d_barrier_probe(cs, 1000, stream)
            if rc:
                raise RuntimeError(f"barrier probe: CUDA error {rc}")
        bar[cs] = time_ms(probe)
    print(f"1,000 cluster.sync() per cluster size, ms: {bar}", flush=True)
    res["barrier_1000_ms"] = bar

    g1 = seed((1, 256, 256))
    per_cs = {}
    for cs in sizes:
        p = CA.ca2d_plan(1, 256, 256, limit, cap, sms, cluster=cs)
        per_cs[cs] = time_ms(lambda: CA.ca2d_run_fused(CA.CA_TEST, g1, 1000,
                                                       p))
    print(f"config #1 (1 x 256^2 x 1000) per cluster size, ms: {per_cs}",
          flush=True)
    res["config1_per_cluster_ms"] = per_cs

    gb = seed((1024, 256, 256))
    p1 = CA.ca2d_plan(1024, 256, 256, limit, cap, sms)
    pb = {"cluster": CA.ca2d_plan(1024, 256, 256, limit, cap, sms, 1),
          "inplace": p1}

    def batch(route):
        return lambda: CA.ca2d_run_fused(CA.CA_TEST, gb, 100, pb[route])

    ab = [("cluster", time_ms(batch("cluster"))),
          ("inplace", time_ms(batch("inplace"))),
          ("inplace", time_ms(batch("inplace"))),
          ("cluster", time_ms(batch("cluster")))]
    print(f"batch 1024 x 256^2 x 100, two buffers (cluster of 1) vs one "
          f"buffer (in place), A B B A, ms: {ab}", flush=True)
    res["batch_routes_ms"] = ab

    if old is not None:
        def run_old(g, steps):
            out = torch.empty_like(g)
            rc = old.ca2d_launch(
                ctypes.c_void_p(g.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                *g.shape, steps, CA.CA_TEST.born_mask, CA.CA_TEST.surv_mask,
                CA.CA_TEST.nr_states, int(CA.CA_TEST.decay), 0,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc:
                raise RuntimeError(f"old kernel: CUDA error {rc}")
            return out

        new1 = CA.ca2d_plan(1, 256, 256, limit, cap, sms)
        for name, g, steps, plan in (("config #1", g1, 1000, new1),
                                     ("batch", gb, 100, p1)):
            same = torch.equal(run_old(g, steps),
                               CA.ca2d_run_fused(CA.CA_TEST, g, steps, plan))
            t = [("old", time_ms(lambda: run_old(g, steps))),
                 ("new", time_ms(lambda: CA.ca2d_run_fused(
                     CA.CA_TEST, g, steps, plan))),
                 ("new", time_ms(lambda: CA.ca2d_run_fused(
                     CA.CA_TEST, g, steps, plan))),
                 ("old", time_ms(lambda: run_old(g, steps)))]
            print(f"{name}: old vs new ({plan.route} route, cluster "
                  f"{plan.cluster}), same output {same}, ms: {t}", flush=True)
            res[f"old_new_{name}"] = t

    big = {}
    for side, steps in ((512, 1000), (1024, 1000), (2048, 5)):
        g = seed((1, side, side))
        p = CA.ca2d_plan(1, side, side, limit, cap, sms)
        big[side] = (p.route, p.cluster, steps,
                     time_ms(lambda: CA.ca2d_run_fused(CA.CA_TEST, g, steps,
                                                       p), 3))
    print(f"single grids (route, cluster, generations, ms): {big}",
          flush=True)
    res["single_grids"] = big

    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
