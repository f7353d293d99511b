"""One rank of the multi-rank CPU tests of the port (gloo).

``tests/test_torch_dist.py`` and ``tests/test_torch_pipeline.py`` start
``WORLD`` copies of this script through :func:`run_world`, one a rank,
each with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``):

    python tests/_torch_dist_worker.py <suite> <directory>

Every rank reads ``<directory>/inputs.pkl`` (weights, batches and LP
arrays made by the test from a numpy seed and the reference), runs the
suite's cases on meshes of the world's ranks, and writes what it saw to
``<directory>/rank<r>.pkl``.  The test compares.  No JAX is imported here.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch import dist as D
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import DistMesh, make_host_mesh, mesh_info
from repro_torch.launch.pipeline import gpipe
from repro_torch.launch.serve import pad_cache
from repro_torch.launch.train import state_specs
from repro_torch.models import build_model
from repro_torch.models.transformer import shard_params, unshard_params
from repro_torch.optim import AdamW, compressed_psum, init_error_state
from repro_torch.optim import lp_clip as lp_clip_mod
from repro_torch.tree import copy_into_, tree_leaves

CPU = torch.device("cpu")
MESHES = ((1, 4), (2, 2), (4, 1))
WORLD = 4
REPO = Path(__file__).resolve().parents[1]


def cfg_of(arch: str, extra: dict):
    return dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32",
                               **extra)


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def grads_case(meshes, inp, arch, shape, extra):
    """The train step's gradients on a mesh, gathered whole."""
    cfg = cfg_of(arch, extra)
    mesh = meshes[shape]
    batch = inp["batch"][arch]
    prog = steps.make_train_step(cfg, mesh, global_batch=4)
    params = shard_params(prog.model, inp["weights"][arch], mesh)
    loss, grads = prog.grads(params, tensors(batch))
    return float(loss), unshard_params(prog.model, grads)


def add_counts(total: dict, before: dict, after: dict) -> None:
    """Add the collectives counted between two ``D.counts()`` to
    ``total``."""
    for op, c in after.items():
        was = before.get(op, {"calls": 0, "bytes": 0})
        if c["calls"] > was["calls"]:
            t = total.setdefault(op, {"calls": 0, "bytes": 0})
            for k in ("calls", "bytes"):
                t[k] += c[k] - was[k]


def train_case(mesh, inp, arch, n_steps, *, lp_clip=False,
               manual_comm=False, compress_pod=False, extra_cfg=None):
    """``n_steps`` train steps from the reference's init: each step's
    loss and lp_s1, the step's LP batch (A, b, c) as numpy, the whole
    parameters after step 1 and at the end, and the collectives the
    steps issued (``counts``)."""
    cfg = cfg_of(arch, extra_cfg or {})
    opt = AdamW(lr=1e-3)
    prog = steps.make_train_step(cfg, mesh, opt, global_batch=4,
                                 lp_clip=lp_clip, manual_comm=manual_comm,
                                 compress_pod=compress_pod)
    params = shard_params(prog.model, inp["weights"][arch], mesh)
    state = opt.init(params)
    extra = {"err": init_error_state(params)} if manual_comm else {}
    batch = tensors(inp["batch"][arch])
    seen = []
    real = lp_clip_mod.make_batch

    def spy(A, b, c, *a, **k):
        seen.append(tuple(t.detach().numpy().copy() for t in (A, b, c)))
        return real(A, b, c, *a, **k)
    if lp_clip:
        lp_clip_mod.make_batch = spy
    out = {"loss": [], "s1": [], "err_max": [], "err_ratio": [],
           "counts": {}}
    real_cp = steps.compressed_psum

    seen_cp = []

    def spy_cp(g, e, axis, mesh):
        """compressed_psum, its inputs and new residuals kept."""
        red, new_e = real_cp(g, e, axis, mesh)
        seen_cp.append((g, e, new_e, axis, mesh))
        return red, new_e
    steps.compressed_psum = spy_cp
    try:
        for i in range(n_steps):
            before = D.counts()
            params, state, m, extra = prog.step(params, state, batch, extra)
            add_counts(out["counts"], before, D.counts())
            # each leaf's new residual over its scale (at most one half: a
            # rounding error), after the step's collectives are counted
            for g, e, new_e, axis, cp_mesh in seen_cp:
                for gi, ei, ni in zip(tree_leaves(g), tree_leaves(e),
                                      tree_leaves(new_e)):
                    amax = D.pmax(torch.amax(torch.abs(gi.float() + ei)),
                                  cp_mesh, (axis,))
                    out["err_ratio"].append(
                        float(ni.abs().max() / (amax / 127.0)))
            seen_cp.clear()
            out["loss"].append(float(m["loss"]))
            out["s1"].append(float(m["lp_s1"]))
            if manual_comm:
                out["err_max"].append(max(float(e.abs().max()) for e in
                                          tree_leaves(extra["err"])))
            if i == 0:
                out["params_1"] = unshard_params(prog.model)
    finally:
        steps.compressed_psum = real_cp
        if lp_clip:
            lp_clip_mod.make_batch = real
    out["params"] = unshard_params(prog.model)
    out["lp"] = seen
    return out



def serve_case(mesh, inp, arch, B, counts=None):
    """Prefill, then 4 teacher-forced decode steps: the logits of each;
    ``counts`` (a dict), when given, gets the collectives of the prefill
    and of the decode steps."""
    cfg = cfg_of(arch, {})
    prefill = steps.make_prefill_step(cfg, mesh, global_batch=B)
    model = prefill.model
    decode = steps.make_decode_step(cfg, mesh, global_batch=B, model=model)
    params = shard_params(model, inp["weights"][arch], mesh)
    s = inp["serve"][arch, B]
    counts = {} if counts is None else counts
    before = D.counts()
    logits, cache = prefill.step(params, tensors({"tokens": s["prompt"]}))
    add_counts(counts.setdefault("prefill", {}), before, D.counts())
    out = [logits.numpy().copy()]
    cache = pad_cache(cache, s["next"].shape[1])
    P = s["prompt"].shape[1]
    for t in range(s["next"].shape[1]):
        tok = torch.from_numpy(s["next"][:, t:t + 1].copy())
        pos = torch.full((B,), P + t, dtype=torch.int32)
        before = D.counts()
        logits, cache = decode.step(params, {"token": tok, "pos": pos},
                                    cache)
        add_counts(counts.setdefault("decode", {}), before, D.counts())
        out.append(logits.numpy().copy())
    return out


def reshard_case(meshes, inp, root: Path):
    """Save on (2, 2), restore onto (4, 1) and (1, 4): the whole leaves
    each mesh gives back."""
    cfg = cfg_of("granite-8b", {"fsdp": True, "fsdp_min_elems": 1})
    mesh_a = meshes[(2, 2)]
    prog = steps.make_train_step(cfg, mesh_a, global_batch=4)
    params = prog.model.init(torch.Generator().manual_seed(3))
    ck = Checkpointer(root)
    specs = {k[2:]: v for k, v in state_specs(prog.model).items()
             if k.startswith("0/")}
    ck.save(1, params, blocking=True, mesh=mesh_a, specs=specs)
    out = {"saved": unshard_params(prog.model)}
    for shape in ((4, 1), (1, 4)):
        mb = build_model(cfg, mesh_info(meshes[shape]), device=CPU)
        like = mb.param_tree()
        sp = {k[2:]: v for k, v in state_specs(mb).items()
              if k.startswith("0/")}
        loaded, _ = ck.load(like, mesh=meshes[shape], specs=sp)
        copy_into_(like, loaded)
        out[shape] = unshard_params(mb)
    return out


def compress_case(pod_mesh, inp):
    """compressed_psum's error feedback over the pod axis: 60 rounds of
    fixed per-rank gradients; the running sum of what it returns against
    the true mean."""
    rng = np.random.default_rng(100 + pod_mesh.coord("pod"))
    g = {"w": torch.from_numpy(rng.standard_normal((64,)).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))}
    err = init_error_state(g)
    acc = {k: torch.zeros_like(v) for k, v in g.items()}
    steps_n = 60
    first = None
    for i in range(steps_n):
        red, err = compressed_psum(g, err, "pod", pod_mesh)
        if first is None:
            first = {k: v.numpy().copy() for k, v in red.items()}
        for k in acc:
            acc[k] += red[k]
    true = {k: D.all_reduce(v, pod_mesh, ("pod",)).numpy() / 2
            for k, v in g.items()}
    return {"acc": {k: v.numpy() for k, v in acc.items()}, "true": true,
            "steps": steps_n, "first": first,
            "err": {k: v.numpy() for k, v in err.items()},
            "g": {k: v.numpy() for k, v in g.items()}}


def lp_case(mesh, inp, method):
    prog = steps.make_lp_step(mesh, batch=inp["lp"]["A"].shape[0],
                              m=inp["lp"]["A"].shape[1], method=method)
    out = prog.step(tensors(inp["lp"]))
    return {k: v.numpy().copy() for k, v in out.items()}


def entry_points_case(root: Path) -> dict:
    """``launch.train.main`` on a 2x2 mesh (3 steps, then resumed to 5)
    and ``launch.serve.main`` on the (ranks, 1) mesh: what each rank
    printed and returned."""
    import contextlib
    import io

    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--mesh", "2,2", "--batch",
            "4", "--seq", "32", "--lp-clip", "--log-every", "1",
            "--ckpt-dir", str(root / "train")]
    out = {}
    for n in (3, 5):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            loss = train_mod.main(argv + ["--steps", str(n)], device=CPU)
        out[f"train_{n}"] = (loss, buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = serve_mod.main(["--arch", "qwen2-0.5b", "--smoke",
                              "--requests", "8", "--batch", "4",
                              "--prompt-len", "16", "--gen", "4"],
                             device=CPU)
    out["serve"] = (run.tokens, buf.getvalue())
    return out


def run_dist(inp, root: Path) -> dict:
    meshes = {s: make_host_mesh(*s, device=CPU) for s in MESHES}
    pod_mesh = DistMesh(("pod", "data", "model"), (2, 2, 1), CPU)
    out = {}
    for arch, shape, extra in inp["grad_cases"]:
        out[("grad", arch, shape)] = grads_case(meshes, inp, arch, shape,
                                                extra)
    D.reset_counts()
    out["train_lp"] = train_case(meshes[(2, 2)], inp, "qwen2-0.5b", 5,
                                 lp_clip=True)
    out["train_counts"] = D.counts()
    out["train_fsdp"] = train_case(
        meshes[(2, 2)], inp, "granite-8b", 2, lp_clip=True,
        extra_cfg={"fsdp": True, "fsdp_min_elems": 1})
    for manual in (False, True):
        out[("manual", manual)] = train_case(
            meshes[(2, 2)], inp, "qwen1.5-0.5b", 3, manual_comm=manual)
    for compress in (False, True):
        out[("pod", compress)] = train_case(
            pod_mesh, inp, "qwen1.5-0.5b", 3, manual_comm=True,
            compress_pod=compress)
    out["compress"] = compress_case(pod_mesh, inp)
    out["reshard"] = reshard_case(meshes, inp, root / "ckpt")
    for method in ("rgb", "naive"):
        out[("lp", method)] = lp_case(meshes[(2, 2)], inp, method)
    for arch, shape, B in inp["serve_cases"]:
        out[("serve_counts", arch, shape)] = counts = {}
        out[("serve", arch, shape)] = serve_case(meshes[shape], inp, arch, B,
                                                 counts)
    out["entry_points"] = entry_points_case(root)
    return out


def run_pipeline(inp, root: Path) -> dict:
    mesh = DistMesh(("pipe",), (4,), CPU)
    W = torch.from_numpy(inp["W"])          # (S, LPS, D, D)
    x = torch.from_numpy(inp["x"])          # (M, MB, D)
    Wl = W[mesh.index(("pipe",))].clone().requires_grad_(True)

    def stage_fn(ws, h):
        for w in ws:
            h = torch.relu(h @ w)
        return h

    D.reset_counts()
    out = gpipe(stage_fn, Wl, x, n_stages=W.shape[0], mesh=mesh)
    loss = torch.sum(out ** 2)
    (g,) = torch.autograd.grad(loss, [Wl])
    gs = D.gather_leaf(g[None], ("pipe",), mesh)
    return {"out": out.detach().numpy(), "grad": gs.numpy(),
            "counts": D.counts()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(suite: str, inputs: dict, root: Path, timeout: int = 600):
    """Start ``WORLD`` ranks of the worker on ``inputs``; their outputs."""
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         suite, str(root)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(logs)
    out = []
    for r in range(WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def main() -> int:
    suite, root = sys.argv[1], Path(sys.argv[2])
    tdist.init_process_group("gloo")
    torch.manual_seed(0)
    with open(root / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    out = {"dist": run_dist, "pipeline": run_pipeline}[suite](inp, root)
    rank = tdist.get_rank()
    with open(root / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    tdist.barrier()
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
