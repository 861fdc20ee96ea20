#!/usr/bin/env python
"""Data-parallel scaling harness: reads/s at 1..N devices of one process.

One process drives every device it sees. Meant for the CPU (set
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 for a
virtual 8-device run); the four-card GPU path is `chip_smoke.py --four`.
Prints one JSON line per device count.
"""
import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
    from pywfa_tpu.ops import engine as E
    from pywfa_tpu.parallel.mesh import DATA_AXIS, make_mesh, sharded_align_batch

    devices = jax.devices()
    n_all = len(devices)
    B_per = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    L = 150

    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)

    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    cfg = E.full_config(attr, L, L, W=128, S_cap=96)
    C = cfg.extend_chunk

    results = {}
    counts = [n for n in (1, 2, 4, 8, n_all) if n <= n_all]
    for n in sorted(set(counts)):
        B = B_per * n
        pats = []
        txts = []
        for _ in range(B):
            p = alpha[rng.integers(0, 4, L)]
            t = p.copy()
            idx = rng.choice(L, 3, replace=False)
            t[idx] = alpha[rng.integers(0, 4, 3)]
            pats.append(p.tobytes())
            txts.append(t.tobytes())
        mesh = make_mesh(devices[:n])
        b1 = NamedSharding(mesh, P(DATA_AXIS))
        b2 = NamedSharding(mesh, P(DATA_AXIS, None))
        pat = jax.device_put(
            jnp.asarray(encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL)), b2)
        txt = jax.device_put(
            jnp.asarray(encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL)), b2)
        plen = jax.device_put(jnp.full((B,), L, jnp.int32), b1)
        tlen = jax.device_put(jnp.full((B,), L, jnp.int32), b1)
        frees = jax.device_put(jnp.zeros((B, 4), jnp.int32), b2)
        ms = jnp.int32(2**31 - 1)
        fn = sharded_align_batch(cfg, mesh)
        out = fn(pat, txt, plen, tlen, frees, ms)
        jax.block_until_ready(out["status"])
        t0 = time.time()
        iters = 3
        for _ in range(iters):
            out = fn(pat, txt, plen, tlen, frees, ms)
        jax.block_until_ready(out["status"])
        dt = (time.time() - t0) / iters
        rps = B / dt
        results[n] = rps
        eff = rps / (results[1] * n) if 1 in results and n > 1 else 1.0
        print(json.dumps({
            "metric": "reads_per_s",
            "devices": n,
            "value": round(rps, 1),
            "unit": "pairs/s",
            "scaling_efficiency": round(eff, 3),
        }))


if __name__ == "__main__":
    main()
