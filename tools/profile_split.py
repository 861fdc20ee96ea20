#!/usr/bin/env python
"""Split the headline-bench time into LCP-build / score-loop / walk parts.

Not a benchmark of record -- a diagnostic for kernel work. Run on the GPU.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = int(os.environ.get("BENCH_B", 4096))
L = int(os.environ.get("BENCH_L", 150))
ITERS = int(os.environ.get("BENCH_ITERS", 10))


def main():
    import jax
    import jax.numpy as jnp
    from bench import make_pairs
    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
    from pywfa_tpu.ops import engine as E

    rng = np.random.default_rng(0)
    pats, txts = make_pairs(rng, B, L, float(os.environ.get("BENCH_DIV", 0.02)))
    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    W = int(os.environ.get("BENCH_W", 128))
    S_cap = int(os.environ.get("BENCH_SCAP", 96))
    cfg = E.full_config(attr, L, L, W=W, S_cap=S_cap)
    C = cfg.extend_chunk

    pat = jnp.asarray(encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL))
    txt = jnp.asarray(encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL))
    plen = jnp.full((B,), L, dtype=jnp.int32)
    tlen = jnp.full((B,), L, dtype=jnp.int32)
    frees = jnp.zeros((B, 4), dtype=jnp.int32)
    max_steps = jnp.int32(2**31 - 1)

    def timeit(name, fn):
        r = fn()
        jax.block_until_ready(r)
        t0 = time.time()
        for _ in range(ITERS):
            r = fn()
        jax.block_until_ready(r)
        dt = (time.time() - t0) / ITERS * 1000
        print(f"{name:28s} {dt:8.2f} ms")
        return r

    # 1. LCP table build alone (h-major layout)
    lcp = timeit("lcp_build_hmajor",
                 lambda: E._build_lcp_table_h(cfg, pat, txt))
    print(f"  lcp table: {lcp.shape} {lcp.dtype} "
          f"{lcp.size * lcp.dtype.itemsize / 2**20:.1f} MB")

    # 2. full align_batch (build + loop)
    out = timeit("align_batch (build+loop)",
                 lambda: E.align_batch(cfg, pat, txt, plen, tlen, frees,
                                       max_steps))
    print(f"  steps (max final_s): {int(np.asarray(out['steps']))}, "
          f"statuses: {np.unique(np.asarray(out['status']), return_counts=True)}")

    # 3. walk alone
    ok = out["status"] == E.ST_END_REACHED
    timeit("traceback_walk",
           lambda: E.traceback_walk(cfg, out["choices"], out["final_s"],
                                    out["end_k"], ok))

    # 4. score-only variant (no choices recording)
    cfg_s = E.full_config(attr, L, L, W=W, S_cap=S_cap, record_choices=False)
    timeit("align_batch score-only",
           lambda: E.align_batch(cfg_s, pat, txt, plen, tlen, frees,
                                 max_steps))


if __name__ == "__main__":
    main()
