"""Deterministic, resumable, shardable token data pipeline.

Design constraints for 1000+-node training:
  * every host must be able to produce ITS shard of the global batch
    without coordination (pure function of (seed, step, host_shard)), so
    restarts and elastic re-sharding need no data redistribution;
  * the cursor is a single integer (step) — checkpointing the pipeline
    is free and exact;
  * two sources: a synthetic LM stream (self-contained; used by tests,
    smoke runs and benchmarks) and a binary token-file source (memory-
    mapped, strided across hosts).

The synthetic stream is not iid noise: it draws from a power-law unigram
distribution with Markov bigram structure so losses move like real text
(useful for convergence smoke tests).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"  # synthetic | file
    path: Optional[str] = None  # token file (np.uint32 flat) for "file"
    # modality stubs
    n_prefix: int = 0          # vlm: patch embeddings per example
    d_model: int = 0
    enc_seq: int = 0           # encdec: frame embeddings per example


class TokenSource:
    """step -> global batch (deterministic)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.source == "file":
            if not cfg.path or not Path(cfg.path).exists():
                raise FileNotFoundError(cfg.path)
            self._tokens = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        else:
            self._tokens = None
            # power-law unigram + shift-register "bigram" mixing
            v = cfg.vocab
            ranks = np.arange(1, v + 1, dtype=np.float64)
            self._probs = (1.0 / ranks ** 1.1)
            self._probs /= self._probs.sum()

    def _synthetic(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, 0xDA7A]))
        B, S = cfg.global_batch, cfg.seq_len
        base = rng.choice(cfg.vocab, size=(B, S + 1), p=self._probs)
        # Markov-ish structure: token_t depends on token_{t-1} half the time
        mix = rng.random((B, S + 1)) < 0.5
        shifted = np.roll(base, 1, axis=1)
        out = np.where(mix, (shifted * 31 + 7) % self.cfg.vocab, base)
        return out.astype(np.int32)

    def _from_file(self, step: int) -> np.ndarray:
        cfg = self.cfg
        B, S = cfg.global_batch, cfg.seq_len
        n = B * (S + 1)
        total = len(self._tokens)
        start = (step * n) % max(total - n, 1)
        chunk = np.asarray(self._tokens[start:start + n], dtype=np.int32)
        return chunk.reshape(B, S + 1) % cfg.vocab

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = (self._from_file(step) if self.cfg.source == "file"
                else self._synthetic(step))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        cfg = self.cfg
        if cfg.n_prefix and cfg.d_model:
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, 0x1113]))
            batch["patches"] = rng.standard_normal(
                (cfg.global_batch, cfg.n_prefix, cfg.d_model),
                dtype=np.float32)
        if cfg.enc_seq and cfg.d_model:
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, 0x2224]))
            batch["frames"] = rng.standard_normal(
                (cfg.global_batch, cfg.enc_seq, cfg.d_model),
                dtype=np.float32)
        return batch

    def host_batch(self, step: int, host_id: int, n_hosts: int
                   ) -> Dict[str, np.ndarray]:
        """The rows of the global batch owned by this host (contiguous
        stride — matches the ('pod','data') batch sharding)."""
        g = self.global_batch(step)
        B = self.cfg.global_batch
        assert B % n_hosts == 0
        per = B // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in g.items()}


def data_stream(cfg: DataConfig, start_step: int = 0,
                host_id: int = 0, n_hosts: int = 1
                ) -> Iterator[Dict[str, np.ndarray]]:
    src = TokenSource(cfg)
    step = start_step
    while True:
        yield src.host_batch(step, host_id, n_hosts)
        step += 1


def for_model(cfg_model, seq_len: int, global_batch: int,
              seed: int = 0, source: str = "synthetic",
              path: Optional[str] = None) -> DataConfig:
    """DataConfig matching a ModelConfig's modality stubs."""
    return DataConfig(
        vocab=cfg_model.vocab,
        seq_len=(seq_len - cfg_model.n_prefix
                 if cfg_model.family == "vlm" else seq_len),
        global_batch=global_batch, seed=seed, source=source, path=path,
        n_prefix=cfg_model.n_prefix if cfg_model.family == "vlm" else 0,
        d_model=cfg_model.d_model if cfg_model.family in ("vlm", "encdec")
        else 0,
        enc_seq=cfg_model.enc_seq if cfg_model.family == "encdec" else 0,
    )
