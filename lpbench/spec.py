"""Find a cell and everything that belongs to it, by name.

``BENCHMARK.json`` at the root of the checkout names the cell's
configuration and traffic mix; each lives in a file of its own, and so does
each piece of code that one of them names:

* ``lpbench/configs/<config>.json``: the deployment (problem, sizes,
  precision, solver and scheduler settings, the reference and the limits of
  its comparison);
* ``lpbench/traffic/<traffic>.json``: the mix (loop, batch or rate,
  outstanding requests, the traced slice), read by the one generator;
* ``lpbench/loops/<loop>.py``: the loop a mix names (``traffic["loop"]``),
  whose ``run(run, seed, seconds, trace, device, clock)`` drives a run;
* ``lpbench/problems/<kind>.py``: the inputs a configuration names
  (``config["problem"]["kind"]``);
* the reference module a configuration names by its path
  (``config["reference"]``), which decides ``correct``;
* ``lpbench/metrics/<metric>.py``: one reader per metric, whose
  ``read(run)`` gives the number or ``None``.

So a cell, a mix, a loop, a kind of problem or a metric is added by adding
files and entries, never by editing one.  A name with no file is refused
when the cell is found, before anything runs.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]   # the end-to-end metrics this cell reports
    per_layer: List[dict]    # the per-layer metrics read in its traced run
    loop: Callable           # ``run`` of lpbench/loops/<loop>.py
    problem: ModuleType      # lpbench/problems/<kind>.py
    reference: ModuleType    # the configuration's reference


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, prefix: str) -> ModuleType:
    """The Python file ``path`` as a module of its own (``KeyError`` when
    there is no such file)."""
    path = Path(path)
    if not path.is_file():
        raise KeyError(f"no file {path}")
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def module(folder: str, name: str, bench_dir: Path = HERE) -> ModuleType:
    """``bench_dir/<folder>/<name>.py``; ``KeyError`` when the name is not
    one or there is no such file."""
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise KeyError(f"{folder}: {name!r} is not a name")
    try:
        return load_file(bench_dir / folder / f"{name}.py",
                         f"lpbench_{folder}_")
    except KeyError:
        raise KeyError(f"{folder}: no file for {name!r} under "
                       f"{bench_dir / folder}") from None


def reference(config: dict, root: Path) -> ModuleType:
    """The reference module a configuration names, by its path from the
    root of the checkout."""
    rel = config.get("reference")
    if not rel or Path(rel).is_absolute() or ".." in Path(rel).parts:
        raise KeyError(f"configuration {config.get('name')!r}: reference "
                       f"{rel!r} is not a path inside the checkout")
    try:
        return load_file(root / rel, "lpbench_reference_")
    except KeyError:
        raise KeyError(f"configuration {config.get('name')!r}: no reference "
                       f"at {root / rel}") from None


def _covers(metric: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def find_cell(name: str, root: Optional[Path] = None,
              bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files from
    ``bench_dir`` (``root/lpbench``); ``KeyError`` when any is missing."""
    root = HERE.parent if root is None else Path(root)
    bench_dir = root / "lpbench" if bench_dir is None else Path(bench_dir)
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = cells[name]
    config = _load_json(bench_dir / "configs" / f"{w['config']}.json")
    traffic = _load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _covers(m, name, [])]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _covers(m, name, names)]
    loop = module("loops", traffic.get("loop"), bench_dir).run
    problem = module("problems", config.get("problem", {}).get("kind"),
                     bench_dir)
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer, loop,
                problem, reference(config, root))


def reader(metric: str, bench_dir: Path = HERE) -> Callable:
    """``read`` of ``lpbench/metrics/<metric>.py``."""
    return module("metrics", metric, bench_dir).read


def read_metrics(metrics: List[dict], run, bench_dir: Path = HERE) -> Dict:
    """``{name: {"value", "unit"}}`` for each metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
