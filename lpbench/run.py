"""Run one cell of the benchmark once.

    python3 lpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json`` (its configuration and traffic
mix from ``lpbench/configs/`` and ``lpbench/traffic/``, and the loop, the
kind of problem and the reference they name: see :mod:`lpbench.spec`),
makes its inputs from the seed, warms the shapes it will use, measures for
``--seconds`` and, with ``--trace 1``, profiles a slice of the same load
after the window.  Then it checks every answer it kept against the plain
reference and prints, as the last line of standard output, one JSON
object: the end-to-end metrics (``--trace 0``) or the per-layer ones
(``--trace 1``), each read by ``lpbench/metrics/<name>.py``, and the
numbers compared beside their limits (also the last lines of standard
error).

It exits non-zero, printing no result, without a CUDA device (or with
fewer than the cell asks for), when the program cannot be imported, or
when ``jax``, ``jaxlib``, ``flax`` or ``repro`` were loaded by the end
(looked at after the comparison and every reader, before anything is
printed).  Every cache the program builds lies under ``build/`` in the
checkout.
"""
from __future__ import annotations

import time

_T_PERF = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _process_start_boottime() -> Optional[float]:
    """This process's start on ``CLOCK_BOOTTIME`` (from ``/proc``)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_T_BOOT = _process_start_boottime()


def since_start() -> float:
    """Seconds since the process started (since this module loaded where
    ``/proc`` says nothing)."""
    if _T_BOOT is not None:
        return time.clock_gettime(time.CLOCK_BOOTTIME) - _T_BOOT
    return time.perf_counter() - _T_PERF


def cache_dirs() -> None:
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")


def _paths() -> None:
    # Run as a script, the harness's own folder heads sys.path: take it off
    # so that its modules are reached only as ``lpbench.*``.
    if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "lpbench":
        sys.path.pop(0)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def _finite(v):
    """A number as it is, or ``None`` for one that JSON cannot hold."""
    return v if isinstance(v, int) or math.isfinite(v) else None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, root=None) -> int:
    """Run the cell; ``device`` is for tests only: it names the device to
    run on and skips the look for a card, and ``root`` a checkout other
    than this one."""
    args = parse(argv)
    cache_dirs()
    _paths()
    import torch
    t_torch = since_start()

    from lpbench import drivers, judge, spec

    root = ROOT if root is None else Path(root)
    bench_dir = root / "lpbench"
    cell = spec.find_cell(args.workload, root, bench_dir)
    if device is None:
        if not torch.cuda.is_available():
            print("lpbench: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"lpbench: {cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"lpbench: the program is not here ({e})", file=sys.stderr)
        return 3
    run = drivers.Run.of(cell)
    run.setup["torch"] = t_torch
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    run.setup["device"] = since_start()
    cell.loop(run, args.seed, args.seconds, bool(args.trace), device,
              since_start)

    correct, checks = judge.verdict(run.tally, run.failed,
                                    cell.config["limits"])
    metrics = spec.read_metrics(
        cell.per_layer if args.trace else cell.end_to_end, run, bench_dir)
    # Last of all, once every reader has run: what the process loaded.
    found = forbidden_modules()
    if found:
        print(f"lpbench: loaded {found}; the port must not", file=sys.stderr)
        return 4
    result = {
        "correct": correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": run.memory_peak_bytes,
        },
    }
    if args.trace:
        sl = run.slice
        result["device"]["busy_s"] = sl.busy_s if sl else 0.0
        result["device"]["window_s"] = sl.length_s if sl else 0.0
        if sl is not None:
            result["breakdown"] = {"device_ops": sl.top_ops(10),
                                   "idle_gaps": sl.idle_by_host(10)}
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    info = dict(run.info)
    info["flush_reasons"] = run.counters.get("flush_reasons", {})
    info["compared"] = run.tally.compared
    info["setup_s_at"] = run.setup
    info["run_s"] = since_start()   # the whole run, the comparison with it
    if sl_calls := (run.slice.calls if args.trace and run.slice else 0):
        info["slice_calls"] = sl_calls
    print(json.dumps({"info": info}))
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
