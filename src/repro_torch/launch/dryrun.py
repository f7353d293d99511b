"""Multi-pod dry run: every (architecture x input shape) step on the
production meshes, counted on ``meta`` tensors: per-device memory, FLOPs,
bytes and collectives, and the roofline terms against a card's peaks.

Counterpart of ``repro.launch.dryrun`` (same functions, flags and record
keys).  The reference lowers and compiles each step for 512 forced host
devices and reads XLA's memory, cost and HLO analyses.  The port runs the
step itself, eagerly, as rank 0 of a
:class:`~repro_torch.launch.mesh.RecordingMesh` (16x16 or 2x16x16): every
tensor is on ``meta`` (nothing is allocated), every collective goes to the
record transport of :mod:`repro_torch.dist` (logged, not issued), and
:func:`repro_torch.roofline.count_meta` counts what ran:

* ``memory`` (per device): ``argument_bytes`` are rank 0's parameter
  shards, optimizer state, batch shard and cache; ``peak_bytes`` the
  high-water mark of live bytes over one step of the real config (remat
  and chunked attention as configured), arguments included, as the card's
  allocator would count them; ``temp_bytes`` the high water above the
  arguments; ``output_bytes`` what the step returns;
* ``roofline``: the counted FLOPs and unfused bytes, the recorded
  collectives (XLA's op names, result bytes), ``model_flops_estimate`` and
  ``fused_hbm_estimate``, against ``peaks_for(card)``.  With ``probe`` the
  counts come from a second run with the reference probe's overrides
  (``flash_threshold=1<<30``, ``remat=False``), so they mean what the
  reference's mean.  The count covers every layer: no depth probes or
  extrapolation (XLA counts a while body once; an eager run does not).

The card is named by ``--peaks`` (how the tests run, with no card) or is
the visible one; each record carries its name and ``"counted_on":
"meta"``.  ``compile_s`` holds the seconds the meta run took.

    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k \\
        [--multi-pod] [--out results.json] [--peaks "NVIDIA H100 80GB HBM3"]
    python -m repro_torch.launch.dryrun --all    # 80 records; --lp: the LP
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch import dist as D
from repro_torch.configs import ARCHS, SHAPES, InputShape, applicable, \
    input_specs
from repro_torch.dist import flat_specs, local_shape
from repro_torch.kernels.batch_lp import rgb_flops
from repro_torch.launch import steps
from repro_torch.launch.mesh import batch_axes, make_production_mesh, \
    mesh_info
from repro_torch.optim import AdamW, init_error_state
from repro_torch.roofline import (count_meta, from_counts,
                                  fused_hbm_estimate, model_flops_estimate,
                                  peaks_for, tensor_bytes)
from repro_torch.tree import flatten_with_paths, unflatten_with_paths

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# The reference probe's overrides (``_probe_cfgs``) but its unrolled scan,
# which has no meaning in an eager run.
PROBE = dict(flash_threshold=1 << 30, remat=False)


def card_name(peaks: Optional[str] = None) -> str:
    """The card a dry run models: ``peaks``, else the visible card."""
    if peaks:
        return peaks
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    raise ValueError("no card is visible: name the card the dry run models "
                     "(--peaks 'NVIDIA H100 80GB HBM3')")


def _local_cache(model, B: int, S: int, mesh):
    """This rank's shard of the ``(B, S)`` cache, on ``meta``."""
    full = model.init_cache(B, S)
    mi = mesh_info(mesh)
    if mi.mesh is None:
        return full
    specs = flat_specs(model.cache_specs(batch_axes(mesh, B)))
    return unflatten_with_paths(
        {k: torch.empty(local_shape(v.shape, specs[k], mesh), dtype=v.dtype,
                        device=v.device)
         for k, v in flatten_with_paths(full).items()}, full)


def build_step(cfg, shape: InputShape, mesh, step_kwargs=None, *,
               memory_bytes: float):
    """The step program for ``(cfg, shape)`` on ``mesh`` and its
    arguments on ``mesh``'s device, uninitialised: ``(program, args,
    local_args)``, ``local_args`` being what rank 0 holds of them (its
    batch rows)."""
    kw = dict(step_kwargs or {})
    batch = input_specs(cfg, shape)
    bax = batch_axes(mesh, shape.batch)
    if shape.kind == "train":
        kw.pop("weight_resident", None)
        opt = AdamW()
        prog = steps.make_train_step(cfg, mesh, opt,
                                     global_batch=shape.batch, **kw)
        params = prog.model.param_tree()
        extra = ({"err": init_error_state(params)}
                 if kw.get("compress_pod") else {})
        args = (params, opt.init(params), batch, extra)
        local = args[:2] + (steps.local_batch(batch, mesh, bax), extra)
    elif shape.kind == "prefill":
        prog = steps.make_prefill_step(cfg, mesh, global_batch=shape.batch,
                                       memory_bytes=memory_bytes, **kw)
        args = (prog.model.param_tree(), batch)
        local = (args[0], steps.local_batch(batch, mesh, bax))
    else:  # decode
        prog = steps.make_decode_step(cfg, mesh, global_batch=shape.batch,
                                      memory_bytes=memory_bytes, **kw)
        cache = _local_cache(prog.model, shape.batch, shape.seq, mesh)
        args = (prog.model.param_tree(), batch, cache)
        local = (args[0], steps.local_batch(batch, mesh, bax), cache)
    return prog, args, local


def dryrun_step(cfg, shape: InputShape, mesh, *, peaks: str,
                step_kwargs=None, probe: bool = False) -> dict:
    """One step of ``(cfg, shape)`` on ``mesh`` (a
    :class:`~repro_torch.launch.mesh.RecordingMesh`, or a ``HostMesh`` on
    ``meta``), counted: ``{"memory", "roofline", "collectives",
    "kernel_calls", "seconds"}`` (``collectives``, ``dist.counts()``, and
    the kernel calls are the real config's)."""
    pk = peaks_for(peaks)
    prog, args, local = build_step(cfg, shape, mesh, step_kwargs,
                                   memory_bytes=pk.memory_bytes)
    arg_bytes = tensor_bytes(local)
    D.reset_counts()
    t0 = time.perf_counter()
    # with probe the counts come from the probe's run: this one gives the
    # memory (and the collectives of the real config) alone
    run = count_meta(prog.step, args, ops=not probe)
    seconds = time.perf_counter() - t0
    collectives = D.counts()
    out_bytes = tensor_bytes(run.out)
    del prog, args, local
    counted = run
    if probe:
        pcfg = dataclasses.replace(cfg, **PROBE)
        p_prog, p_args, _ = build_step(pcfg, shape, mesh, step_kwargs,
                                       memory_bytes=pk.memory_bytes)
        counted = count_meta(p_prog.step, p_args, live=False)
    mi = mesh_info(mesh)
    roof = from_counts(
        counted.flops, counted.bytes, chips=getattr(mesh, "world", 1),
        model_flops=model_flops_estimate(cfg, shape.kind, shape.batch,
                                         shape.seq),
        peaks=pk, coll_by_op=counted.coll_by_op,
        hbm_fused=fused_hbm_estimate(cfg, shape.kind, shape.batch,
                                     shape.seq, mi.model_size, mi.data_size))
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": run.peak_bytes - arg_bytes,
              "peak_bytes": run.peak_bytes}
    return {"memory": memory, "roofline": roof, "collectives": collectives,
            "kernel_calls": run.kernel_calls, "seconds": seconds}


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                overrides: dict | None = None, verbose: bool = True,
                probe: bool = True, step_kwargs: dict | None = None,
                variant: str = "baseline",
                peaks: Optional[str] = None) -> dict:
    cfg = ARCHS[arch]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    card = card_name(peaks)
    if not applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "variant": variant,
                "reason": "long_500k needs sub-quadratic mixing",
                "counted_on": "meta", "peaks": card}
    mesh = make_production_mesh(multi_pod=multi_pod, record=True)
    res = dryrun_step(cfg, shape, mesh, peaks=card, step_kwargs=step_kwargs,
                      probe=probe)
    roof, mem = res["roofline"], res["memory"]
    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "chips": mesh.world, "status": "ok", "variant": variant,
        "compile_s": round(res["seconds"], 2), "memory": mem,
        "roofline": roof.as_dict(), "counted_on": "meta", "peaks": card,
        "fits": mem["peak_bytes"] <= roof.peaks.memory_bytes,
        "collectives": res["collectives"],
        "kernel_calls": res["kernel_calls"],
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} ({_mesh_name(multi_pod)}): "
              f"meta run {res['seconds']:.1f}s  "
              f"bottleneck={roof.bottleneck}  "
              f"frac={roof.roofline_fraction:.3f}")
        print(f"  terms: compute={roof.t_compute*1e3:.2f}ms  "
              f"memory={roof.t_memory*1e3:.2f}ms  "
              f"collective={roof.t_collective*1e3:.2f}ms  "
              f"useful={roof.useful_ratio:.3f}  "
              f"args/dev={mem['argument_bytes']/1e9:.2f}GB  "
              f"peak/dev={mem['peak_bytes']/1e9:.2f}GB of "
              f"{roof.peaks.memory_bytes/1e9:.0f}GB")
    return rec


def dryrun_lp(*, multi_pod: bool = False, batch: int = 1 << 20,
              m: int = 256, method: str = "rgb",
              peaks: Optional[str] = None) -> dict:
    """The paper's own workload on the production mesh: ``make_lp_step``
    on rank 0's ``batch / chips`` problems.  The plain ``"rgb"`` solve
    skips a tile when no problem in it is violated, a host read of the
    data that ``meta`` cannot answer: its record says so
    (``status="not_on_meta"``) and counts nothing."""
    card = card_name(peaks)
    pk = peaks_for(card)
    mesh = make_production_mesh(multi_pod=multi_pod, record=True)
    prog = steps.make_lp_step(mesh, batch=batch, m=m, method=method)

    def spec(shp, dt=torch.float32):
        return torch.empty(shp, dtype=dt, device="meta")
    bd = {"A": spec((batch, m, 2)), "b": spec((batch, m)),
          "c": spec((batch, 2)), "m_valid": spec((batch,), torch.int32)}
    rec = {"arch": f"lp-{method}", "shape": f"b{batch}_m{m}",
           "multi_pod": multi_pod, "chips": mesh.world,
           "counted_on": "meta", "peaks": card}
    D.reset_counts()
    t0 = time.perf_counter()
    try:
        run = count_meta(prog.step, (bd,))
    except RuntimeError as e:
        if "meta" not in str(e):
            raise
        rec.update(status="not_on_meta",
                   reason=f"the solve reads a value back to the host: {e}")
        print(f"[dryrun] lp-{method} b={batch} m={m}: not countable on "
              f"meta ({e})")
        return rec
    local = steps.local_batch(bd, mesh, mesh_info(mesh).data_axes
                              + ("model",))
    roof = from_counts(run.flops, run.bytes, chips=mesh.world,
                       model_flops=rgb_flops(batch, m), peaks=pk,
                       coll_by_op=run.coll_by_op)
    rec.update(status="ok", compile_s=round(time.perf_counter() - t0, 2),
               memory={"argument_bytes": tensor_bytes(local),
                       "output_bytes": tensor_bytes(run.out),
                       "temp_bytes": run.peak_bytes - tensor_bytes(bd),
                       "peak_bytes": run.peak_bytes},
               roofline=roof.as_dict(), collectives=D.counts())
    print(f"[dryrun] lp-{method} b={batch} m={m}: "
          f"bottleneck={roof.bottleneck} frac={roof.roofline_fraction:.3f}")
    return rec


def _key(r: dict) -> tuple:
    return (r["arch"], r["shape"], r.get("multi_pod", False),
            r.get("variant", "baseline"))


def write_records(records: list, out=None) -> Path:
    """Merge ``records`` into the JSON list at ``out`` (default
    ``RESULTS_DIR/dryrun.json``), a record replacing the one of its
    ``(arch, shape, multi_pod, variant)``; returns the path."""
    p = Path(out) if out else RESULTS_DIR / "dryrun.json"
    p.parent.mkdir(parents=True, exist_ok=True)
    existing = json.loads(p.read_text()) if p.exists() else []
    keyed = {_key(r): r for r in existing}
    for r in records:
        keyed[_key(r)] = r
    p.write_text(json.dumps(list(keyed.values()), indent=1))
    return p


def _cell_job(job: tuple) -> dict:
    """One cell of the sweep (in a worker process): its record, or a
    ``FAIL`` record."""
    arch, shape, mp, kw, card = job
    try:
        return dryrun_cell(arch, shape, multi_pod=mp, step_kwargs=kw,
                           peaks=card)
    except Exception as e:  # a failure here is a real bug
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "multi_pod": mp,
                "status": "FAIL", "error": repr(e), "counted_on": "meta",
                "peaks": card}


def sweep(card: str, *, jobs: int = 1) -> list:
    """Every (arch x shape) on both meshes, in the reference's order, over
    ``jobs`` processes: the baseline sweep, FSDP serving gathers as the
    reference's.  Unlike the reference, which counts its roofline on the
    single-pod mesh only, every cell is counted (with the probe's
    overrides)."""
    base_kw = {"weight_resident": False}
    todo = [(a, s, mp, base_kw, card) for a in ARCHS for s in SHAPES
            for mp in (False, True)]
    if jobs <= 1:
        return [_cell_job(j) for j in todo]
    import concurrent.futures as cf
    import multiprocessing as mp_
    # the long cells first (chunked attention at 32k), so none is last
    order = sorted(range(len(todo)),
                   key=lambda i: todo[i][1] != "prefill_32k")
    with cf.ProcessPoolExecutor(jobs, mp_context=mp_.get_context("spawn")
                                ) as pool:
        done = dict(zip(order, pool.map(_cell_job,
                                        [todo[i] for i in order])))
    return [done[i] for i in range(len(todo))]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on both meshes")
    ap.add_argument("--lp", action="store_true",
                    help="LP-solver dry-run (methods rgb and naive)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--peaks", default=None,
                    help="the card to model (default: the visible card)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes for --all (each cell runs in one)")
    args = ap.parse_args(argv)

    card = card_name(args.peaks)
    records = []
    if args.lp:
        for method in ("rgb", "naive"):
            records.append(dryrun_lp(multi_pod=args.multi_pod,
                                     method=method, peaks=card))
    elif args.all:
        records = sweep(card, jobs=args.jobs)
    else:
        records.append(dryrun_cell(args.arch, args.shape,
                                   multi_pod=args.multi_pod, peaks=card))

    p = write_records(records, args.out)
    print(f"wrote {len(records)} records -> {p}")
    n_fail = sum(1 for r in records if r["status"] == "FAIL")
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run cells FAILED")
    return records


if __name__ == "__main__":
    main()
