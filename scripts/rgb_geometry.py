#!/usr/bin/env python3
"""Time the RGB kernel under each launch geometry it takes, on the card.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
and ``nvcc``::

    python3 scripts/rgb_geometry.py [--out FILE] [--src DIR] [--calls-only]
    python3 scripts/rgb_geometry.py --table-rows

At the shapes ``chip_smoke.py`` drives (its solver shapes, the serving
path's widest flush and its smallest, and the unstaged shape) it launches
``rgb_cuda`` on the same full-width feasible batch under:

* ``grid``      one CTA per tile of 8 (the default: one problem a warp);
* ``tile32``    one CTA per tile of 32: each warp walks four problems
  through its one staging region;
* ``unstaged``  the global-memory regime at the same shape, tile 8 and
  8 warps, as a shape too wide to stage gets (at a shape that would be
  staged; through the wrapper's private ``_launch``, which takes a
  geometry).

With ``--table-rows`` it times, instead, the shape of every kernel row of
the bundled tuning table for this card (``m_bucket`` lane-rounded, every
problem ``m_bucket`` wide, ``batch_bucket`` problems): the row's tile
(``table``) against the default tile 8 (``grid``), both through
``rgb_cuda`` at ``chunk`` 0, as a solve at that shape launches them.

With ``--calls-only`` it times only the call every version of the wrapper
takes (tile 8, ``chunk`` 0 and 128), so ``--src`` can point at the
``src/`` of an earlier commit unpacked beside this one and the two kernels
be compared in one run on one card (earlier, this, this, earlier).

Each line is one JSON object: device milliseconds per launch (``ms``: 20
launches replayed from one CUDA graph, CUDA events) and milliseconds per
eager call (``call_ms``: 20 calls, CUDA events), the geometry, and whether
the outputs equal the default geometry's in every bit (they must: the
script exits non-zero otherwise).  The last line names the card and its
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the smoke run's inputs and timer)

SHAPES = ((16384, 256, "float32"), (16384, 256, "float64"),
          (2048, 2048, "float32"), (2048, 2048, "float64"),
          (1024, 1024, "float32"), (32, 1024, "float32"),
          (64, 19456, "float32"))


def variants(m_pad: int, itemsize: int):
    from repro_torch.kernels.batch_lp import LaunchGeometry, launch_geometry
    g = launch_geometry(m_pad, itemsize, 8)
    out = [("grid", 8, g),
           ("tile32", 32, launch_geometry(m_pad, itemsize, 32))]
    if g.staged:
        out.append(("unstaged", 8, LaunchGeometry(8, 0, False)))
    return out


def table_shapes():
    """``[(B, m, m_pad, dtype, tile), ...]`` of the bundled table's kernel
    rows for this card."""
    from repro_torch.kernels.batch_lp import LANE
    from repro_torch.tune import current_device_kind, default_table
    kind = current_device_kind()
    return [(e.key.batch_bucket, e.key.m_bucket,
             -(-e.key.m_bucket // LANE) * LANE, e.key.dtype, e.tile)
            for e in default_table().entries()
            if e.key.backend == "kernel" and e.key.device_kind == kind]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="directory to import repro_torch from, e.g. the "
                         "src/ of an earlier commit unpacked beside this one")
    ap.add_argument("--calls-only", action="store_true",
                    help="time only rgb_cuda(L, c, m_valid, M=, tile=8, "
                         "chunk=c) for chunk 0 and 128: the call every "
                         "version of the wrapper takes")
    ap.add_argument("--table-rows", action="store_true",
                    help="at each kernel row of the bundled tuning table, "
                         "the row's tile against tile 8")
    args = ap.parse_args()
    # Before chip_smoke's own entry, which names this checkout's src/.
    sys.path.insert(0, os.path.abspath(args.src))
    if not torch.cuda.is_available():
        print("rgb_geometry: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import card_info
    from repro_torch.kernels import batch_lp
    dev = torch.device("cuda", 0)
    card = card_info()
    lines = []
    ok = True
    if args.table_rows:
        shapes = table_shapes()
        if not shapes:
            print("rgb_geometry: the bundled table has no kernel rows for "
                  "this card", file=sys.stderr)
            return 1
    else:
        shapes = [(B, m_pad, m_pad, dtype, None)
                  for B, m_pad, dtype in SHAPES]
    for si, (B, m, m_pad, dtype, row_tile) in enumerate(shapes):
        rng = np.random.default_rng([cs.SEED, 7, si])
        A, b, c = cs.feasible_arrays(rng, B, m)
        L, cc, mv = cs.packed_on(dev, A, b, c, np.full((B,), m, np.int32),
                                 dtype, m_pad)
        base = None
        if args.table_rows:
            runs = [(name, tile, None, lambda tile=tile:
                     batch_lp.rgb_cuda(L, cc, mv, M=1.0e4, tile=tile,
                                       chunk=0))
                    for name, tile in (("grid", 8), ("table", row_tile))
                    if name == "grid" or tile != 8]
        elif args.calls_only:
            runs = [(f"chunk{chunk}", 8, None, lambda chunk=chunk:
                     batch_lp.rgb_cuda(L, cc, mv, M=1.0e4, tile=8,
                                       chunk=chunk))
                    for chunk in (0, 128)]
        else:
            runs = [(name, tile, g, lambda tile=tile, g=g:
                     batch_lp._launch(L, cc, mv, 1.0e4, tile, g))
                    for name, tile, g in variants(m_pad, L.element_size())]
        for name, tile, g, launch in runs:
            x, f = launch()
            torch.cuda.synchronize()
            if base is None:
                base = (x, f)
            same = (torch.equal(cs.bits(x), cs.bits(base[0]))
                    and torch.equal(f, base[1]))
            ok = ok and same
            ms = cs.time_device(launch)
            call_ms = cs.time_launches(launch)
            lines.append({"B": B, "m": m, "m_pad": m_pad, "dtype": dtype,
                          "variant": name, "tile": tile,
                          "geometry": g._asdict() if g else None,
                          "src": args.src, "ms": ms, "call_ms": call_ms,
                          "bits_equal_default": same, "card": card})
            print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            for ln in lines:
                fh.write(json.dumps(ln) + "\n")
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
