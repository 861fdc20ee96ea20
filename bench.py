#!/usr/bin/env python
"""Benchmark: batched gap-affine alignment with full CIGAR on one chip.

Headline metric (BASELINE.md): alignment cell-updates/s at 150bp, batch=4096,
affine penalties, full-CIGAR scope. "Cell updates" uses the standard
GCUPS-equivalent convention: plen * tlen DP cells per pair (the work a
classic DP aligner would do for the same workload).

Times the device pipeline (score loop + walk + packing, inputs staged on
the device) with block_until_ready; fails unless JAX's device is a GPU.
Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"}, the device stamped with platform, kind, count and the card's
name and power limit.
"""
import json
import os
import sys
import time

import numpy as np

BASELINE_CELLS_PER_S = 10e6  # BASELINE.md north-star: >= 10M cell-updates/s

B = int(os.environ.get("BENCH_B", 4096))
L = int(os.environ.get("BENCH_L", 150))
ITERS = int(os.environ.get("BENCH_ITERS", 5))
DIVERGENCE = float(os.environ.get("BENCH_DIV", 0.02))


def make_pairs(rng, n, length, divergence):
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats = alphabet[rng.integers(0, 4, size=(n, length))]
    txts = pats.copy()
    nmut = max(1, int(length * divergence))
    for i in range(n):
        idx = rng.choice(length, size=nmut, replace=False)
        txts[i, idx] = alphabet[(rng.integers(1, 4, size=nmut)
                                 + np.searchsorted(alphabet, txts[i, idx])) % 4]
    return ([pats[i].tobytes() for i in range(n)],
            [txts[i].tobytes() for i in range(n)])


def main():
    import jax
    import jax.numpy as jnp
    from chip_smoke import SmokeFailure, stamp_device
    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
    from pywfa_tpu.ops import engine as E

    try:
        dev, card = stamp_device()  # fails unless the platform is gpu
    except SmokeFailure as e:
        sys.exit(f"bench: {e}")
    rng = np.random.default_rng(0)
    pats, txts = make_pairs(rng, B, L, DIVERGENCE)

    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    # sized bucket: bounded band + score cap with escalation unnecessary at
    # this divergence (2% of 150bp -> scores ~< 40)
    W = int(os.environ.get("BENCH_W", 128))
    S_cap = int(os.environ.get("BENCH_SCAP", 96))
    cfg = E.full_config(attr, L, L, W=W, S_cap=S_cap)
    # production parity: dispatch compacts the walk-op pull at
    # non-terminal rungs (batch.align_pairs_dispatch ops_out rule)
    import dataclasses as _dc
    oc = min(cfg.S_cap, max(32, E._round_up(cfg.S_cap // 3, 2)))
    if oc < cfg.S_cap:
        cfg = _dc.replace(cfg, ops_out=oc)
    C = cfg.extend_chunk

    pat_np = encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL)
    txt_np = encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL)
    plens_np = np.full((B,), L, dtype=np.int32)
    tlens_np = np.full((B,), L, dtype=np.int32)
    plen = jnp.asarray(plens_np)
    tlen = jnp.asarray(tlens_np)
    frees_np = np.zeros((B, 4), dtype=np.int32)
    frees = jnp.asarray(frees_np)
    max_steps = jnp.int32(2**31 - 1)

    from pywfa_tpu.batch import pack_tokens
    fused2 = jnp.asarray(np.concatenate(
        [pack_tokens(pat_np, plens_np, width=cfg.Lp),
         pack_tokens(txt_np, tlens_np, width=cfg.Lt)],
        axis=1))

    def run():
        return E.align_batch_packed_full(cfg, fused2, plen, tlen, frees,
                                         max_steps)

    # warm-up / compile + correctness probe
    packed = np.asarray(run())
    if E.packed_layout(cfg) == "compact":
        status, fb = packed[:B].astype(np.int32), packed[B: 2 * B]
    else:
        meta = packed[: 7 * B * 4].view(np.int32).reshape(7, B)
        status, fb = meta[0], meta[6]
    n_ok = int((status == E.ST_END_REACHED).sum())
    assert n_ok == B, f"only {n_ok}/{B} pairs completed in bucket"
    assert not fb.any(), "traceback fallback triggered"

    # device pipeline time per batch, inputs staged on the device
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))

    cells = B * L * L
    cells_per_s = cells / dt
    result = {
        "metric": "alignment_cell_updates_per_s",
        "value": round(cells_per_s, 1),
        "unit": "cells/s",
        "vs_baseline": round(cells_per_s / BASELINE_CELLS_PER_S, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }
    print(f"# batch={B} len={L} iters={ITERS} time/batch={dt * 1000:.3f} ms "
          f"alignments/s={B / dt:.0f} [{card}]", file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
