"""Serving the LM zoo: prefill a prompt, then batched greedy decode,
with the banded-precision KV option (near window bf16, far blocks int8 on
the `mp_attention` kernel) compared against exact attention.

The port of `examples/serve_lm.py`:

    python -m repro_torch.serve_lm --tokens 24            # on the card
    python -m repro_torch.serve_lm --device cpu           # plain versions
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from .kernels.mp_attention.ops import banded_decode_attention, quantize_kv
from .models.config import ArchConfig
from .models.decode import decode_step, prefill, quantize_rows
from .models.transformer import init_lm

# the example's own demo model
DEMO = ArchConfig(name="serve-demo", family="dense", n_layers=4, d_model=128,
                  n_heads=8, n_kv_heads=4, d_head=16, d_ff=512, vocab=1024,
                  remat=False)


def _grow_cache(cache, n: int, *, kv_quant: bool):
    """Full-attention entries get n empty slots on the S axis (SWA entries
    are circular and keep their window); with kv_quant the rows become int8
    with per-row scales, as decode_step writes them.  The recurrent blocks'
    entries and whisper's cross entry (the encoder's keys, all attended:
    zero keys there would take softmax weight) are constant in S and pass
    through unchanged, in bf16."""
    out = {}
    for key, entry in cache.items():
        if key == "cross" or "k" not in entry:
            out[key] = entry
            continue
        entry = dict(entry)
        if "pos" not in entry:
            for name in ("k", "v"):
                entry[name] = F.pad(entry[name], (0, 0, 0, 0, 0, n))
        if kv_quant:
            for name in ("k", "v"):
                entry[name], entry[name + "_scale"] = quantize_rows(
                    entry[name].float())
        out[key] = entry
    return out


def _wait(t) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def generate(params, cfg, prompt, n_new: int, *, kv_quant: bool = False,
             frames=None, extra_embeds=None, compute_dtype=torch.bfloat16,
             stats: dict | None = None):
    """Greedy generation of n_new tokens after prompt (B, S), with whisper's
    `frames` (B, F, d) or the vision stub's `extra_embeds` (B, P, d).

    Prefill, grow the cache by n_new slots, then n_new - 1 decode steps at
    positions S_total, S_total + 1, ... (S_total = P + S, the prefill's
    length): the last token is returned but never written.  Returns (ids
    (B, n_new) int64, cache).  A `stats` dict, if given, receives
    prefill_s, decode_s and decode_steps, each timed up to a device
    synchronisation.
    """
    s = prompt.shape[1]
    if extra_embeds is not None:  # decode positions count the patches
        s += extra_embeds.shape[1]
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt, cfg, extra_embeds=extra_embeds,
                            frames=frames, compute_dtype=compute_dtype)
    cache = _grow_cache(cache, n_new, kv_quant=kv_quant)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    if stats is not None:
        _wait(tok)
        stats["prefill_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = [tok]
    for i in range(n_new - 1):
        logits, cache = decode_step(params, cache, tok, s + i, cfg,
                                    compute_dtype=compute_dtype)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        out.append(tok)
    ids = torch.cat(out, dim=1)
    if stats is not None:
        _wait(ids)
        stats["decode_s"] = time.perf_counter() - t1
        stats["decode_steps"] = n_new - 1
    return ids, cache


def exact_attention(q, k, v, sm_scale: float):
    """Full softmax in fp32. q: (B, G, d); k, v: (B, S, d) -> (B, G, d)."""
    scores = torch.einsum("bgd,bsd->bgs", q.float(), k.float()) * sm_scale
    return torch.einsum("bgs,bsd->bgd", torch.softmax(scores, dim=-1),
                        v.float())


def cache_bytes_saved(near_slots: int, far_slots: int) -> float:
    """Share of a bf16 cache's bytes saved by storing the far slots int8."""
    return 1 - (near_slots * 2 + far_slots) / ((near_slots + far_slots) * 2)


def fold_banded(cache_k, cache_v, length: int, *, near: int,
                blk: int = 128):
    """One layer's served cache as the two segments of the banded-precision
    attention.

    cache_k, cache_v: (B, S, KV, hd), folded to (B*KV, S, hd); length:
    filled positions.  The first floor((length - near) / blk) * blk
    positions become the int8 far segment (`quantize_kv`); the rest the near
    segment in the cache's dtype, padded to a multiple of blk.  Slots past
    `length` are masked.  Returns the `banded_decode_attention` arguments
    (k_near, v_near, near_len, k_far, v_far, far_scales, far_len) and the
    folded (k, v) of the filled positions.
    """
    b, s, kv, hd = cache_k.shape
    if not 0 < length <= s:
        raise ValueError(f"length {length} outside 1..{s}")

    def fold(t):
        return t[:, :length].permute(0, 2, 1, 3).reshape(b * kv, length, hd)

    def lengths(n):
        return torch.full((b * kv,), n, dtype=torch.int32, device=k.device)

    k, v = fold(cache_k), fold(cache_v)
    far_n = max(length - near, 0) // blk * blk
    near_n = length - far_n
    k_far, v_far, scales = quantize_kv(k[:, :far_n], v[:, :far_n], blk=blk)
    pad = -near_n % blk
    k_near = F.pad(k[:, far_n:], (0, 0, 0, pad))
    v_near = F.pad(v[:, far_n:], (0, 0, 0, pad))
    segments = (k_near, v_near, lengths(near_n), k_far, v_far, scales,
                lengths(far_n))
    return segments, (k, v)


def banded_kv_attention(cache_k, cache_v, q, length: int, *, near: int,
                        blk: int = 128):
    """One layer's served cache (B, S, KV, hd) through the banded-precision
    attention (segments as `fold_banded` cuts them) for q (B*KV, G, hd).
    Returns (banded output, exact attention over the same positions), both
    (B*KV, G, hd) fp32."""
    segments, (k, v) = fold_banded(cache_k, cache_v, length, near=near,
                                   blk=blk)
    sm_scale = cache_k.shape[-1] ** -0.5
    out = banded_decode_attention(q, *segments, blk=blk, sm_scale=sm_scale)
    return out, exact_attention(q, k, v, sm_scale)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = DEMO
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_lm(gen, cfg, device=device)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    ids, _ = generate(params, cfg, prompt, args.tokens)
    print("generated token ids:")
    for i in range(args.batch):
        print(f"  seq{i}: {ids[i].tolist()}")

    # --- banded-precision KV attention demo (paper technique -> serving) --
    print("\nbanded-precision KV (near bf16 window + far int8 blocks):")
    b, g, d, sn, sf = 2, 4, 64, 128, 256

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q = normal(b, g, d)
    kn, vn = normal(b, sn, d), normal(b, sn, d)
    kf, vf = normal(b, sf, d), normal(b, sf, d)
    kq, vq, scales = quantize_kv(kf, vf)
    near_len = torch.full((b,), sn, dtype=torch.int32, device=device)
    far_len = torch.full((b,), sf, dtype=torch.int32, device=device)
    out = banded_decode_attention(q, kn, vn, near_len, kq, vq, scales, far_len,
                                  sm_scale=d ** -0.5)
    exact = exact_attention(q, torch.cat([kn, kf], 1), torch.cat([vn, vf], 1),
                            d ** -0.5)
    err = float((out - exact).abs().max())
    print(f"  max error vs exact attention: {err:.2e}")
    print(f"  far-segment cache bytes saved: {cache_bytes_saved(sn, sf):.0%} "
          "(decode reads the cache from device memory: fewer bytes, "
          "less time per step)")


if __name__ == "__main__":
    main()
