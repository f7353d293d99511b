"""Offline tuner on the port: measure launch-geometry candidates, emit a table.

The PyTorch twin of ``benchmarks/tune_cli.py``: runs
:func:`repro_torch.tune.tune` over a shape grid on the device (the card
unless ``device="cpu"``), streams one JSON row per timed candidate (the
reference's keys plus ``card``), and writes a versioned
:class:`~repro_torch.tune.TuningTable` only where ``--out`` says:

    python -m benchmarks.pt_tune_cli                    # quick grid
    python -m benchmarks.pt_tune_cli --full             # paper-sized grid
    python -m benchmarks.pt_tune_cli --out tables/dev.json --merge
    python -m benchmarks.pt_tune_cli --smoke            # CI assertion mode

Point ``REPRO_TORCH_TUNE_TABLE`` at a written file to make solvers use it;
the bundled ``src/repro_torch/tune/default_table.json`` is rewritten by
``scripts/tune_table.py``, never by this module.

``--smoke`` runs a tiny space and *asserts* the subsystem contract: the
table round-trips save -> load -> merge unchanged, and
``SolverSpec.resolve_for_shape`` resolves to a recorded entry when the
table is active (explicit values still win).
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

from benchmarks.pt_common import emit
from repro_torch.device import as_device, card_info
from repro_torch.solver import SolverSpec
from repro_torch.tune import TuningTable, current_device_kind, tune, use_table

QUICK_SHAPES = [(32, 256), (128, 512)]
FULL_SHAPES = [(16, 1024), (32, 4096), (128, 4096), (256, 1024),
               (512, 1024), (1024, 512)]
SMOKE_SHAPES = [(16, 32)]


def _row_cb(rows, card):
    def on_result(r):
        row = {
            "bench": "tune", "device_kind": r.device_kind,
            "backend": r.candidate.backend, "tile": r.candidate.tile,
            "chunk": r.candidate.chunk, "m_pad": r.m_pad,
            "batch": r.batch, "dtype": r.dtype, "seconds": r.seconds,
            "us_per_lp": r.us_per_lp, "card": card,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
        emit(f"tune/m{r.m_pad}/b{r.batch}/{r.candidate.label()}",
             r.seconds, f"us_per_lp={r.us_per_lp:.2f}")
    return on_result


def _smoke_assertions(table: TuningTable, shapes, device) -> None:
    platform = device.type
    kind = "cpu" if platform == "cpu" else current_device_kind()
    # 1. the table round-trips load -> merge -> save bit-stably
    with tempfile.TemporaryDirectory() as td:
        p1 = Path(td) / "t1.json"
        table.save(p1)
        loaded = TuningTable.load(p1)
        assert loaded == table, "save -> load changed the table"
        merged = TuningTable().merge(loaded).merge(table)
        assert merged == table, "merge is not idempotent"
        p2 = merged.save(Path(td) / "t2.json")
        assert p2.read_text() == p1.read_text(), \
            "round-tripped JSON differs"
    # 2. resolution picks a recorded entry when the table is active
    m, batch = shapes[0]
    with use_table(table):
        spec = SolverSpec(backend="rgb").resolve_for_shape(
            m, batch, platform=platform)
        hit = table.lookup(backend="rgb", dtype="float32", m=m,
                           batch=batch, device_kind=kind)
        assert hit is not None, "tuner recorded no rgb entry"
        assert (spec.tile, spec.chunk) == (hit.tile, hit.chunk), (
            f"resolution picked ({spec.tile}, {spec.chunk}), table has "
            f"({hit.tile}, {hit.chunk})")
    # 3. explicit user values still win over the recorded entry
    with use_table(table):
        spec = SolverSpec(backend="rgb", tile=8, chunk=0).resolve_for_shape(
            m, batch, platform=platform)
        assert (spec.tile, spec.chunk) == (8, 0), \
            "explicit tile/chunk lost to the table"
    print("tune_cli --smoke ok: table round-trips and resolution "
          "prefers recorded entries (explicit still wins)")


def run(full: bool = False, smoke: bool = False, out: str | None = None,
        merge: bool = False, backends=None, iters: int | None = None,
        warmup: int = 1, *, device=None):
    device = as_device(device)
    if smoke:
        shapes, backends = SMOKE_SHAPES, backends or ("rgb",)
        iters = iters or 1
    elif full:
        shapes = FULL_SHAPES
        iters = iters or 5
    else:
        shapes = QUICK_SHAPES
        iters = iters or 3
    rows = []
    table = tune(shapes, backends=backends, warmup=warmup, iters=iters,
                 on_result=_row_cb(rows, card_info()), device=device)
    if smoke:
        _smoke_assertions(table, shapes, device)
    if out:
        path = Path(out)
        if merge and path.exists():
            table = TuningTable.load(path).merge(table)
        table.save(path)
        kind = "cpu" if device.type == "cpu" else current_device_kind()
        print(f"wrote {len(table)} entries for {kind!r} to {path}")
    return rows, table


def main(argv=None, *, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny space + subsystem contract assertions")
    ap.add_argument("--out", default=None,
                    help="write the resulting table JSON here")
    ap.add_argument("--merge", action="store_true",
                    help="merge into an existing --out (faster wins)")
    ap.add_argument("--backends", default=None,
                    help="comma-separated subset (default: per device)")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=1)
    args = ap.parse_args(argv)
    backends = tuple(args.backends.split(",")) if args.backends else None
    run(full=args.full, smoke=args.smoke, out=args.out,
        merge=args.merge, backends=backends, iters=args.iters,
        warmup=args.warmup, device=device)


if __name__ == "__main__":
    main()
