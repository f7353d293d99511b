"""The training entry point, on one card or on a mesh of ranks.

Counterpart of ``repro.launch.train`` with its flags and log lines.
Composes: config registry, data pipeline, the train step, AdamW (+
optional LP trust-region clipping — the paper's solver in the training
loop, the CUDA kernel ``rgb_cuda`` once a step on a card), checkpointing
with resume, heartbeat + straggler monitoring.

    python -m repro_torch.launch.train --arch qwen2-0.5b --lp-clip \\
        --steps 20 --batch 8 --seq 512 --ckpt-dir /tmp/ckpt

It runs on the card; ``main(argv, device="cpu")`` runs it on the CPU, as
the tests do.  Under ``torchrun`` (or in a process whose process group is
initialised) it trains on a ``(data, model)`` mesh of the ranks:
``--mesh d,m`` (default: every rank on the data axis, as the reference's
default), ``--production-mesh`` (16x16; ``--multi-pod`` 2x16x16).  Each
rank runs on card ``LOCAL_RANK % device_count`` with NCCL (gloo on the
CPU); logging, checkpoints and the heartbeat are rank 0's, and a
checkpoint holds whole leaves, so it resumes on any mesh::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-0.5b --mesh 2,2 --lp-clip --steps 20
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.data.pipeline import TokenSource, for_model
from repro_torch.device import DeviceLike
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.elastic import Heartbeat, StragglerMonitor
from repro_torch.dist import flat_specs
from repro_torch.launch.mesh import (HostMesh, init_process_group,
                                     make_host_mesh, make_production_mesh)
from repro_torch.optim import AdamW
from repro_torch.tree import copy_into_


def state_specs(model) -> dict:
    """The specs of the sharded leaves of ``(params, AdamWState)`` by the
    checkpoint's slash paths: the parameters and both moments."""
    out = {}
    for path, spec in flat_specs(model.full_param_specs()).items():
        for prefix in ("0", "1/1", "1/2"):
            out[f"{prefix}/{path}"] = spec
    return out


def _launched_with_ranks() -> bool:
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def main(argv=None, *, device: DeviceLike = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config for CPU runs")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lp-clip", action="store_true",
                    help="LP trust-region update scaling (the paper's "
                         "batch solver inside the optimizer)")
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="data,model (default: every rank as data)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_config(cfg)

    import torch.distributed as tdist
    if args.production_mesh or _launched_with_ranks():
        device = init_process_group(device)
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    if args.production_mesh:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device=device)
    elif args.mesh:
        d, m = (int(x) for x in args.mesh.split(","))
        mesh = make_host_mesh(d, m, device=device)
    else:
        mesh = make_host_mesh(world, 1, device=device)
    dev = mesh.device
    lead = isinstance(mesh, HostMesh) or mesh.rank == 0
    log = print if lead else (lambda *a, **k: None)

    optimizer = AdamW(lr=args.lr)
    prog = steps_mod.make_train_step(
        cfg, mesh, optimizer, global_batch=args.batch,
        lp_clip=args.lp_clip)
    step_fn = prog.jit()

    params = prog.model.init(
        torch.Generator(device=dev).manual_seed(args.seed))
    opt_state = optimizer.init(params)
    extra = {}

    dcfg = for_model(cfg, args.seq, args.batch, seed=args.seed,
                     source=args.data, path=args.data_path)
    src = TokenSource(dcfg)

    start = 0
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    sharded = ({} if isinstance(mesh, HostMesh)
               else {"mesh": mesh, "specs": state_specs(prog.model)})
    if ckpt is not None and ckpt.latest_step() is not None:
        (loaded, opt_state), meta = ckpt.load((params, opt_state),
                                              **sharded)
        copy_into_(params, loaded)
        start = int(meta.get("next_step", 0))
        log(f"[train] resumed from step {start}")

    hb = Heartbeat(args.heartbeat) if args.heartbeat and lead else None
    strag = StragglerMonitor()
    act = getattr(torch, cfg.dtype)

    t_last = time.time()
    for step in range(start, args.steps):
        batch = src.global_batch(step)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        for k in ("patches", "frames"):
            if k in batch:
                batch[k] = batch[k].to(act)
        params, opt_state, metrics, extra = step_fn(
            params, opt_state, batch, extra)
        dt = time.time() - t_last
        t_last = time.time()
        slow = strag.record(step, dt)
        if hb is not None:
            hb.beat(step)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            s1 = float(metrics["lp_s1"])
            log(f"[train] step {step:6d} loss {loss:8.4f} "
                  f"dt {dt*1e3:8.1f}ms lp_s1 {s1:.3f}"
                  + ("  STRAGGLER" if slow else ""), flush=True)
        # (the last step's state is saved once, below; the reference
        # saves it here too and then again)
        if (ckpt is not None and (step + 1) % args.ckpt_every == 0
                and step + 1 < args.steps):
            ckpt.save(step + 1, (params, opt_state),
                      extra={"next_step": step + 1}, **sharded)
    if ckpt is not None:
        ckpt.save(args.steps, (params, opt_state),
                  extra={"next_step": args.steps}, blocking=True, **sharded)
    log(f"[train] done; median step {strag.median*1e3:.1f}ms, "
          f"{len(strag.flagged)} straggler steps")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
