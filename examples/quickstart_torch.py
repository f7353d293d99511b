"""Quickstart of the PyTorch/CUDA port: one batch of 2-D LPs, every
backend, one spec sweep.  On the card ``backend="kernel"`` launches the
hand-written CUDA kernel (``rgb_cuda``); on the CPU, which must be asked
for, it runs the kernel's plain PyTorch version.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python -c "import sys; sys.path.insert(0, 'examples'); \\
        import quickstart_torch as q; q.main(['--batch', '256'], device='cpu')"
"""
import argparse
import time

import torch

from repro_torch.core import LPBatch, pack, random_feasible_lp
from repro_torch.device import as_device
from repro_torch.solver import SolverSpec


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, *, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--plain-slice", type=int, default=None,
                    help="solve only the first N problems with the plain "
                         "backends (naive, rgb) and compare there; the "
                         "kernel solves the whole batch")
    args = ap.parse_args(argv)
    dev = as_device(device)
    B, m = args.batch, args.m
    print(f"batch of {B} LPs with {m} constraints each on {dev}")
    lp = random_feasible_lp(torch.Generator(device=dev).manual_seed(0),
                            B, m, device=dev)

    # One frozen spec per backend; shuffle=True applies Seidel's random
    # consideration order (keyed by seed) inside every solve.
    sweep = (
        SolverSpec(backend="naive", shuffle=True, seed=1),
        SolverSpec(backend="rgb", tile=8, chunk=64, shuffle=True, seed=1),
        SolverSpec(backend="kernel", shuffle=True, seed=1),
    )

    n = B if args.plain_slice is None else min(args.plain_slice, B)
    part = LPBatch(A=lp.A[:n], b=lp.b[:n], c=lp.c[:n],
                   m_valid=lp.m_valid[:n])
    sols, ms = {}, {}
    for spec in sweep:
        batch = lp if spec.backend == "kernel" else part
        solver = spec.build(device=dev)
        solver.solve(batch)                      # first touch
        _sync(dev)
        t0 = time.perf_counter()
        out = solver.solve(batch)
        _sync(dev)
        dt = time.perf_counter() - t0
        nb = batch.batch
        sols[spec.backend] = out
        ms[spec.backend] = dt * 1e3
        print(f"  {spec.backend:8s}: {dt*1e3:8.1f} ms "
              f"({dt/nb*1e6:6.2f} us/LP), "
              f"{int(out.feasible.sum())}/{nb} feasible")

    for k in ("rgb", "kernel"):
        torch.testing.assert_close(sols[k].objective[:n],
                                   sols["naive"].objective,
                                   rtol=5e-4, atol=5e-4)
    print("all backends agree to 5 significant figures "
          "(the paper's comparison tolerance)")

    # Solving the same batch repeatedly?  Pack once into the canonical
    # SoA layout and hand the PackedLPBatch to any solver — results are
    # bit-identical to the AoS path, with zero per-call repacking.
    solver = sweep[1].build(device=dev)
    packed_x = solver.solve(pack(part)).x
    if not torch.equal(packed_x, solver.solve(part).x):
        raise AssertionError("the pre-packed solve differs from the AoS "
                             "solve")
    print("pre-packed solve is bit-identical to the AoS solve")
    return {"batch": B, "m": m, "plain_batch": n, "device": str(dev),
            "ms": ms,
            "feasible": {k: int(s.feasible.sum()) for k, s in sols.items()},
            "max_objective_diff": max(
                float((sols[k].objective[:n] - sols["naive"].objective)
                      .abs().max()) for k in ("rgb", "kernel"))}


if __name__ == "__main__":
    main()
