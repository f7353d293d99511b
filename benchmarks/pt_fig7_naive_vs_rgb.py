"""Paper Figure 7 on the port: cooperative RGB over NaiveRGB.

The PyTorch twin of ``benchmarks/fig7_naive_vs_rgb.py``: the same tile and
chunk variants of the plain ``rgb`` backend against ``naive``, and the
randomisation ablation on the adversarial order.  These rows time the
port's plain backends; on a card the paper's own comparison, kernel over
naive, is read off the ``kernel`` and ``naive`` rows of
``pt_fig3_lp_size`` and ``pt_solver_sweep``.
"""
from __future__ import annotations

from benchmarks.pt_common import (emit, generator, plain_timing, shapes,
                                  time_fn)
from repro_torch.core import (adversarial_lp, normalize_batch,
                              random_feasible_lp, shuffle_batch)
from repro_torch.device import as_device
from repro_torch.solver import SolverSpec

VARIANTS = (
    ("rgb-t32", SolverSpec(backend="rgb", tile=32, chunk=0,
                           normalize=False)),
    ("rgb-t32-c64", SolverSpec(backend="rgb", tile=32, chunk=64,
                               normalize=False)),
    ("rgb-t8-c64", SolverSpec(backend="rgb", tile=8, chunk=64,
                              normalize=False)),
)
NAIVE = SolverSpec(backend="naive", normalize=False)
ADVERSARIAL = SolverSpec(backend="rgb", normalize=False)
SIZES = (32, 128, 512, 2048)
QUICK_SIZES = (32, 256)
B = 1024
ADV_BATCH = 256


def case(B: int, m: int, device=None):
    lp = normalize_batch(random_feasible_lp(generator(m, device), B, m,
                                            device=device))
    return shuffle_batch(generator(4, device), lp)


def adversarial_case(m: int, device=None):
    """``(adversarial order, the same problems shuffled)``."""
    adv = normalize_batch(adversarial_lp(ADV_BATCH, m, device=device))
    return adv, shuffle_batch(generator(0, device), adv)


def run(full: bool = False, *, device=None, plain_quick: bool = False):
    device = as_device(device)
    timing = plain_timing(plain_quick)
    rows = []
    for (m,), plain in shapes([(m,) for m in SIZES],
                              [(m,) for m in QUICK_SIZES], full,
                              plain_quick):
        lp = case(B, m, device)
        t_naive = time_fn(NAIVE.build(device).solve, lp, device=device)
        rows.append(emit(f"fig7/b{B}/m{m}/naive", t_naive, ""))
        if not plain:
            continue
        for label, spec in VARIANTS:
            t = time_fn(spec.build(device).solve, lp, device=device,
                        **timing)
            rows.append(emit(f"fig7/b{B}/m{m}/{label}", t,
                             f"over_naive={t_naive/t:.2f}x"))

    # randomisation ablation (Seidel's expected-O(m) claim)
    m = 512 if full and not plain_quick else 128
    adv, shuf = adversarial_case(m, device)
    solver = ADVERSARIAL.build(device)
    t_adv = time_fn(solver.solve, adv, device=device, **timing)
    t_shuf = time_fn(solver.solve, shuf, device=device, **timing)
    rows.append(emit(f"fig7/adversarial/m{m}", t_shuf,
                     f"shuffle_speedup={t_adv/t_shuf:.2f}x"))
    return rows


if __name__ == "__main__":
    run(full=True)
