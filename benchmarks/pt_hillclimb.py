"""Perf hillclimb cells on the port's dry run.

The PyTorch twin of ``benchmarks/hillclimb.py``: the same five (arch x
shape, variant) cells, each counted on ``meta`` by
``repro_torch.launch.dryrun.dryrun_cell(..., variant=)`` and recorded under
its ``variant`` key beside the baseline records:

  * ``weight-resident`` (granite-8b ``decode_32k``): serving keeps the TP
    weight shard resident instead of FSDP-gathering it per token;
  * ``fused-psum`` (arctic-480b ``train_4k`` and ``decode_32k``): the MoE
    and dense residual sums in one psum, the port's only code path (the
    reference's too), re-probed;
  * ``vma-transpose`` (granite-8b and internlm2-20b ``train_4k``) has no
    counterpart: it is ``shard_map``'s ``check_rep=True``, and the port
    places gradients by hand (``repro_torch.dist``), so there is no
    flag to flip.  Those cells are recorded ``status: "no_counterpart"``.

Run after the baseline sweep (it shares the records file)::

    PYTHONPATH=src python -m benchmarks.pt_hillclimb [--peaks NAME] [--jobs 3]

Without ``--peaks`` the dry run models the visible card, and raises where
there is none.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import (RESULTS_DIR, card_name, dryrun_cell,
                                       write_records)

RESULTS = RESULTS_DIR / "dryrun.json"

NO_VMA = ("check_rep=True is a shard_map flag; the port places gradients "
          "by hand (repro_torch.dist), so the variant has no counterpart")

CELLS = [
    ("granite-8b", "train_4k", "vma-transpose", {"check_rep": True}),
    ("granite-8b", "decode_32k", "weight-resident",
     {"weight_resident": True}),
    ("arctic-480b", "train_4k", "fused-psum", {"weight_resident": False}),
    ("arctic-480b", "decode_32k", "fused-psum", {"weight_resident": False}),
    ("internlm2-20b", "train_4k", "vma-transpose", {"check_rep": True}),
]


def cell(arch: str, shape: str, variant: str, kw: dict, card: str) -> dict:
    """One cell's record (a ``FAIL`` record when the count raises, as in
    the reference)."""
    if "check_rep" in kw:
        return {"arch": arch, "shape": shape, "multi_pod": False,
                "variant": variant, "status": "no_counterpart",
                "reason": NO_VMA, "peaks": card}
    try:
        return dryrun_cell(arch, shape, multi_pod=False, probe=True,
                           step_kwargs=kw, variant=variant, peaks=card)
    except Exception as e:
        import traceback
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "multi_pod": False,
                "variant": variant, "status": "FAIL", "error": repr(e),
                "peaks": card}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peaks", default=None,
                    help="the card to model (default: the visible card)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes (each cell runs in one)")
    args = ap.parse_args(argv)
    card = card_name(args.peaks)
    jobs = [(*c, card) for c in CELLS]
    if args.jobs <= 1:
        records = [cell(*j) for j in jobs]
    else:
        import concurrent.futures as cf
        import multiprocessing as mp
        with cf.ProcessPoolExecutor(args.jobs,
                                    mp_context=mp.get_context("spawn")
                                    ) as pool:
            records = list(pool.map(cell, *zip(*jobs)))
    out = write_records(records, RESULTS)
    print(f"hillclimb variants written -> {out}")
    failed = [(r["arch"], r["shape"], r["variant"]) for r in records
              if r["status"] == "FAIL"]
    if failed:
        raise SystemExit(f"hillclimb cells FAILED: {failed}")
    return records


if __name__ == "__main__":
    main()
