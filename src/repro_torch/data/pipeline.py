"""Deterministic, resumable, host-sharded synthetic data pipeline.

The port of `repro.data.pipeline`.  Counter-based generation: batch(step)
is a pure function of (seed, step, process_index), so every process draws
its own shard with no coordination, restoring `data_step` from a
checkpoint resumes the stream exactly, and a different process count after
a restart re-partitions the same logical stream.

The stream keeps the reference's law, not its random bits (JAX's threefry
is not reproduced): each batch is drawn on the CPU from a torch.Generator
seeded by the triple, then moved to the source's device, so the card and
the CPU see the same tokens.  The vision stub's patches and whisper's
frames (fp32 standard normal, the reference's law) are drawn from the same
generator after the tokens, so the token stream of every family is the
same with them or without.  `FileSource` reads a flat .npy of tokens and
gives the reference's batches bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    n_processes: int = 1
    process_index: int = 0


def _generator(*counters: int) -> torch.Generator:
    """A CPU generator seeded by a hash of the counters (one seed per
    (seed, step, process_index), with no collisions between neighbours)."""
    digest = hashlib.blake2b(repr(counters).encode(), digest_size=8).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest, "little")
                                         >> 1)


class SyntheticTokenSource:
    """Synthetic token stream with learnable structure.

    Row r follows t_i = (t0 + a * i + noise_i) mod vocab with a in [1, 8),
    t0 in [0, vocab) and noise_i in [0, 3) drawn per row, so a real LM can
    reduce its loss on it; labels are the tokens shifted by one.  With the
    vision stub, patches (B, n_patches, d); with whisper, frames (B,
    n_enc_frames, d); both fp32 standard normal, drawn after the tokens."""

    def __init__(self, cfg, dc: DataConfig, *, device="cuda"):
        self.cfg = cfg
        self.dc = dc
        self.device = device
        if dc.global_batch % dc.n_processes:
            raise ValueError(f"global_batch {dc.global_batch} is not a "
                             f"multiple of n_processes {dc.n_processes}")
        self.local_batch = dc.global_batch // dc.n_processes

    def batch_at(self, step: int):
        gen = _generator(self.dc.seed, step, self.dc.process_index)
        b, s, v = self.local_batch, self.dc.seq_len, self.cfg.vocab
        a = torch.randint(1, 8, (b, 1), generator=gen)
        t0 = torch.randint(0, v, (b, 1), generator=gen)
        noise = torch.randint(0, 3, (b, s + 1), generator=gen)
        idx = torch.arange(s + 1)[None, :]
        stream = ((t0 + a * idx + noise) % v).to(torch.int32)
        batch = {"tokens": stream[:, :-1].contiguous(),
                 "labels": stream[:, 1:].contiguous()}
        if self.cfg.frontend == "vision_stub":
            batch["patches"] = torch.randn(
                (b, self.cfg.n_patches, self.cfg.d_model), generator=gen)
        if self.cfg.enc_dec:
            batch["frames"] = torch.randn(
                (b, self.cfg.n_enc_frames, self.cfg.d_model), generator=gen)
        return {k: x.to(self.device) for k, x in batch.items()}


class FileSource:
    """Memmap-backed tokenized corpus reader (the same interface).

    Expects a flat .npy of integer tokens; step/process determinism comes
    from strided offsets, so resume and re-sharding match the synthetic
    source."""

    def __init__(self, cfg, dc: DataConfig, path: str, *, device="cuda"):
        self.cfg, self.dc = cfg, dc
        self.device = device
        self.data = np.load(path, mmap_mode="r")
        self.local_batch = dc.global_batch // dc.n_processes

    def batch_at(self, step: int):
        b, s = self.local_batch, self.dc.seq_len
        span = s + 1
        base = (step * self.dc.global_batch
                + self.dc.process_index * b) * span
        rows = [np.asarray(self.data[(base + i * span) % (len(self.data) - span):]
                           [:span]) for i in range(b)]
        arr = torch.from_numpy(np.stack(rows).astype(np.int32))
        return {"tokens": arr[:, :-1].contiguous().to(self.device),
                "labels": arr[:, 1:].contiguous().to(self.device)}
