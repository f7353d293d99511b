#!/usr/bin/env python3
"""Measure the port's tuning table on the card and write it.

Runs :func:`repro_torch.tune.tune` on the first CUDA device over the
shapes ``backend="auto"`` and the serving layer's SLO controller route
on, streams one JSON row per timed candidate, and writes the winners
per backend as ``src/repro_torch/tune/default_table.json`` (the bundled
table)::

    python3 scripts/tune_table.py                 # write the bundled table
    python3 scripts/tune_table.py --out t.json    # somewhere else

Shapes (``m_pad x batch``):

* the reference tuner's full grid (``benchmarks/tune_cli.py``
  ``FULL_SHAPES``), float32;
* the serving ladder, ``bucket_m`` 128/256/512/1024 at a batch of 1024
  (what the scheduler flushes with ``max_batch=1024``), float32;
* the paper's figure-3 shape, ``256 x 16384``, float32 and float64.

A backend's row at a shape is the candidate a table miss would run
(``tune.space.heuristic_candidate``) unless another is faster by more than
the larger of the two IQRs: the solve call is host-bound on the card, and
the tiles' differences in kernel time sit inside its noise.  Kernel
candidates are timed 200 times each (a call is ~0.3 ms), pdhg candidates
3 times (a call is 1-50 s).

Every row of the written table is a timing this script took on this
card, and nothing is seeded from a heuristic.  The backends it times
(``--backends``, by default the card's: kernel and pdhg) are written
fresh; the rows of backends it does not time are kept from the file it
rewrites::

    python3 scripts/tune_table.py --backends kernel   # re-time the kernel rows

The table is rewritten after every shape, so a run cut short keeps the
shapes it finished; at the end the table's round trip (save -> load ->
merge) is checked.  Needs a CUDA device; without one it exits non-zero
and writes nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

FULL_SHAPES = [(16, 1024), (32, 4096), (128, 4096), (256, 1024),
               (512, 1024), (1024, 512)]
SERVE_SHAPES = [(128, 1024), (256, 1024), (512, 1024), (1024, 1024)]
FIG3_SHAPE = (256, 16384)
DEFAULT_OUT = ROOT / "src" / "repro_torch" / "tune" / "default_table.json"
# Untimed calls before each candidate's timed ones, and timed calls.  A
# kernel call is ~0.3 ms, and the first one at a shape pays the
# allocator's first touch (and, at the first shape, the kernel's build):
# timed cold, it loses to any warm candidate; 200 timed calls cost well
# under a second.  A pdhg call is 1-50 s on an NVIDIA H100 80GB HBM3 at
# 700 W, next to which a cold start is noise, and every call adds minutes
# to the run.
WARMUP = {"kernel": 10, "pdhg": 0}
ITERS = {"kernel": 200, "pdhg": 3}


def plan():
    """``[(dtype, [(m_pad, batch), ...]), ...]`` to tune."""
    f32 = []
    for s in FULL_SHAPES + SERVE_SHAPES + [FIG3_SHAPE]:
        if s not in f32:
            f32.append(s)
    return [("float32", f32), ("float64", [FIG3_SHAPE])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="where to write the table JSON")
    ap.add_argument("--backends", nargs="+", choices=sorted(ITERS),
                    help="backends to time (default: the card's); rows of "
                         "the others are kept from --out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_table: no CUDA device; the table is measured on the "
              "card only", file=sys.stderr)
        return 2

    from repro_torch.device import card_info, default_device
    from repro_torch.tune import (TuningTable, check_round_trip,
                                  current_device_kind, default_backends,
                                  tune)

    device = default_device()
    card = card_info()
    backends = tuple(args.backends or default_backends())
    out = Path(args.out)
    kept = TuningTable.load(out).entries() if out.exists() else []
    table = TuningTable(e for e in kept if e.key.backend not in backends)

    def on_result(r):
        print(json.dumps({
            "bench": "tune", "device_kind": r.device_kind,
            "backend": r.candidate.backend, "tile": r.candidate.tile,
            "chunk": r.candidate.chunk, "m_pad": r.m_pad,
            "batch": r.batch, "dtype": r.dtype, "seconds": r.seconds,
            "iqr_seconds": r.iqr_seconds, "k": r.k,
            "us_per_lp": r.us_per_lp, "card": card}), flush=True)

    def write(t):
        tmp = out.with_suffix(".tmp")
        t.save(tmp)
        os.replace(tmp, out)

    t0 = time.perf_counter()
    for dtype, shapes in plan():
        for shape in shapes:
            for backend in backends:
                tune([shape], dtype=dtype, backends=(backend,),
                     warmup=WARMUP[backend], iters=ITERS[backend],
                     table=table, on_result=on_result, device=device)
            write(table)    # a cut run keeps the shapes it finished
    try:
        check_round_trip(table)
    except ValueError as e:
        raise SystemExit(f"tune_table: {e}")
    winners = [{"backend": e.key.backend, "dtype": e.key.dtype,
                "m_bucket": e.key.m_bucket,
                "batch_bucket": e.key.batch_bucket, "tile": e.tile,
                "chunk": e.chunk, "us_per_lp": e.us_per_lp,
                "us_iqr": e.us_iqr, "k": e.k} for e in table.entries()]
    print(json.dumps({"phase": "tune_table", "entries": len(table),
                      "backends_timed": backends,
                      "device_kind": current_device_kind(), "card": card,
                      "seconds": time.perf_counter() - t0,
                      "winners": winners}), flush=True)
    write(table)
    print(f"tune_table: wrote {len(table)} entries for "
          f"{current_device_kind()!r} to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
