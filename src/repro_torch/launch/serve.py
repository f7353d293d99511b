"""Batched serving entry point: continuous prefill + decode over a request
queue (the inference-side end-to-end example), on one card or, launched
with several ranks (``torchrun``), on the reference's ``(ranks, 1)`` mesh:
each rank serves its rows of every batch and rank 0 prints.

Counterpart of ``repro.launch.serve`` with its flags and log lines: each
batch of prompts is prefilled at once, its KV cache grown to the whole
generation, and every row decoded greedily (``argmax``, the first maximum
on ties, as ``jnp.argmax``) one token a step.

    python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --requests 16 --batch 8 --prompt-len 512 --gen 32

It runs on the card; ``main(argv, device="cpu")`` (with ``--smoke``) runs
it on the CPU, as the tests do.  :func:`serve` is the loop itself: it
takes a model, its parameters and the prompts, so weights made elsewhere
(the reference's, through ``params_from_numpy``) can be served.

Two things differ from the reference on purpose (ROADMAP C):

* only the self-attention ``k``/``v`` grow, found by name (top level, or
  the hybrid's ``attn``), by the length the prefill gave them, and decode
  positions start there (:func:`prefill_length`).  The reference grows
  every cache axis 2 equal to ``--prompt-len`` and starts at
  ``--prompt-len``, so a VLM's cache (patch prefix + prompt) is never
  grown, each decode write is clamped onto the last prompt slot, and
  RoPE sees positions short by the prefix; an encoder-decoder's
  ``xk``/``xv`` (encoder length) would be grown whenever ``--prompt-len``
  equals it, and so would an SSM cache's head axis (``--prompt-len`` equal
  to the heads) or its conv windows (``--prompt-len`` equal to
  ``ssm_conv - 1``);
* generated tokens stay on the device until a batch ends (the reference
  copies each step's token to the host); the tokens are the same.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, List

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.device import DeviceLike
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (HostMesh, init_process_group,
                                     make_host_mesh)
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class ServeRun:
    """What one :func:`serve` call did.  Times are CUDA-event times on a
    card (host clock on the CPU); ``seconds`` is the host clock around
    the whole loop."""
    tokens: List[np.ndarray]        # (B, gen) per batch
    prefill_ms: List[float]         # per batch
    decode_ms: List[List[float]]    # per batch, per decode step
    seconds: float
    cache_bytes: int                # one batch's grown cache

    @property
    def n_tokens(self) -> int:
        return sum(t.size for t in self.tokens)


class _Marks:
    """Timestamps on the device's clock (CUDA events) or the host's."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> int:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())
        return len(self.marks) - 1

    def ms(self, a: int, b: int) -> float:
        """Milliseconds from mark ``a`` to mark ``b`` (after both ran)."""
        if self.cuda:
            return self.marks[a].elapsed_time(self.marks[b])
        return (self.marks[b] - self.marks[a]) * 1e3


def prefill_length(cache: dict, n_tokens: int) -> int:
    """Where decode positions start after a prefill of ``n_tokens``
    tokens that gave ``cache``: the self-attention cache's length (top
    level, or the hybrid's ``attn``; a VLM's counts its patch prefix), or
    ``n_tokens`` for an SSM, whose cache has no sequence axis (and which
    reads no position)."""
    kv = cache if "k" in cache else cache.get("attn")
    return n_tokens if kv is None else int(kv["k"].shape[2])


def pad_cache(cache: dict, n_new: int) -> dict:
    """Grow the self-attention ``k``/``v`` along their sequence axis by
    ``n_new`` zero slots, after the length the prefill gave them; every
    other entry (``pos``, the cross-attention ``xk``/``xv``, the SSM
    ``state`` and ``conv_*`` windows) as it is."""
    out = dict(cache)
    if "attn" in cache:
        out["attn"] = pad_cache(cache["attn"], n_new)
    if "k" not in cache:
        return out
    for name in ("k", "v"):
        x = cache[name]
        grown = x.new_zeros(x.shape[:2] + (x.shape[2] + n_new,)
                            + x.shape[3:])
        grown[:, :, :x.shape[2]] = x
        out[name] = grown
    return out


def cache_bytes(cache) -> int:
    """The bytes of every tensor in a (nested) cache."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache))


def make_prompts(vocab: int, requests: int, batch: int, prompt_len: int,
                 seed: int) -> List[np.ndarray]:
    """The reference's prompts: one ``(batch, prompt_len)`` int32 draw a
    batch from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (batch, prompt_len), dtype=np.int32)
            for _ in range(-(-requests // batch))]


def serve(model, params, prompts: List[np.ndarray], *, gen: int,
          prefill: Callable, decode: Callable) -> ServeRun:
    """Serve each batch of ``prompts`` with ``model``'s weights
    ``params`` through its serving steps ``prefill`` and ``decode``
    (``launch.steps``): prefill, grow the cache by ``gen``, take the
    greedy token, then ``gen - 1`` decode steps."""
    cfg, dev = model.cfg, model.device
    act = getattr(torch, cfg.dtype)
    marks = _Marks(dev)
    spans = []
    outs_all = []
    n_bytes = 0
    t0 = time.time()
    for prompt in prompts:
        B = prompt.shape[0]
        batch = {"tokens": torch.as_tensor(prompt, device=dev)}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros((B, cfg.n_prefix, cfg.d_model),
                                           dtype=act, device=dev)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                                          dtype=act, device=dev)
        a = marks.mark()
        logits, cache = prefill(params, batch)
        b = marks.mark()
        spans.append(("prefill", a, b))
        # prompt_len, or n_prefix + prompt_len
        cur = prefill_length(cache, prompt.shape[1])
        cache = pad_cache(cache, gen)
        n_bytes = cache_bytes(cache)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        outs = [tok]
        pos = torch.full((B,), cur, dtype=torch.int32, device=dev)
        steps = []
        for t in range(gen - 1):
            a = marks.mark()
            logits, cache = decode(params, {"token": tok, "pos": pos + t},
                                   cache)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            b = marks.mark()
            steps.append((a, b))
            outs.append(tok)
        spans.append(("decode", steps))
        outs_all.append(torch.cat(outs, dim=1).cpu().numpy())
    seconds = time.time() - t0
    if marks.cuda:
        torch.cuda.synchronize(dev)
    prefill_ms = [marks.ms(s[1], s[2]) for s in spans if s[0] == "prefill"]
    decode_ms = [[marks.ms(a, b) for a, b in s[1]]
                 for s in spans if s[0] == "decode"]
    return ServeRun(tokens=outs_all, prefill_ms=prefill_ms,
                    decode_ms=decode_ms, seconds=seconds,
                    cache_bytes=n_bytes)


def main(argv=None, *, device: DeviceLike = None) -> ServeRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_config(cfg)
    import torch.distributed as tdist
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = init_process_group(device)
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    mesh = make_host_mesh(world, 1, device=device)
    log = print if isinstance(mesh, HostMesh) or mesh.rank == 0 else (
        lambda *a, **k: None)
    B = args.batch

    prefill = steps_mod.make_prefill_step(cfg, mesh, global_batch=B)
    model = prefill.model
    decode = steps_mod.make_decode_step(cfg, mesh, global_batch=B,
                                        model=model)
    params = model.init(
        torch.Generator(device=mesh.device).manual_seed(args.seed))

    prompts = make_prompts(cfg.vocab, args.requests, B, args.prompt_len,
                           args.seed)
    run = serve(model, params, prompts, gen=args.gen,
                prefill=prefill.jit(), decode=decode.jit())
    for b, gen in enumerate(run.tokens):
        log(f"[serve] batch {b}: generated {gen.shape} tokens; "
            f"sample row: {gen[0][:8]}")
    log(f"[serve] {run.n_tokens} tokens in {run.seconds:.2f}s "
          f"({run.n_tokens / run.seconds:.1f} tok/s)")
    return run


if __name__ == "__main__":
    main()
