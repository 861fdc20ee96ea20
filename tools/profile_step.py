#!/usr/bin/env python
"""Micro-profile one engine step's pieces on the device (diagnostic)."""
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = int(os.environ.get("BENCH_B", 4096))
L = int(os.environ.get("BENCH_L", 150))
ITERS = int(os.environ.get("BENCH_ITERS", 20))


def main():
    import jax
    import jax.numpy as jnp
    from bench import make_pairs
    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
    from pywfa_tpu.ops import engine as E

    rng = np.random.default_rng(0)
    pats, txts = make_pairs(rng, B, L, 0.02)
    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    cfg = E.full_config(attr, L, L, W=128, S_cap=96)
    C = cfg.extend_chunk

    pat = jnp.asarray(encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL))
    txt = jnp.asarray(encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL))
    plen = jnp.full((B,), L, dtype=jnp.int32)
    tlen = jnp.full((B,), L, dtype=jnp.int32)
    frees = jnp.zeros((B, 4), dtype=jnp.int32)

    lcp = E._build_lcp_table_h(cfg, pat, txt)
    jax.block_until_ready(lcp)
    state = jax.jit(lambda: E._init_state(cfg, B, plen, tlen, frees,
                                          jnp.int32(2**31 - 1)))()
    jax.block_until_ready(state)

    def timeit(name, fn, *args):
        r = fn(*args)
        jax.block_until_ready(r)
        t0 = time.time()
        for _ in range(ITERS):
            r = fn(*args)
        jax.block_until_ready(r)
        dt = (time.time() - t0) / ITERS * 1e6
        print(f"{name:34s} {dt:9.1f} us")
        return r

    off = state["offsets"][0, 0]
    band = jnp.ones((B, cfg.W), dtype=bool)

    ext = jax.jit(lambda lcp, off: E._extend_band_lcp_h(cfg, lcp, tlen, off,
                                                        band))
    timeit("extend_lcp_h (one-hot stream)", ext, lcp, off)

    # gather flavor for comparison
    def ext_gather(lcp, off):
        Ltp = lcp.shape[0]
        idx = jnp.clip(off, 0, Ltp - 1)
        lcp_w = jnp.transpose(lcp, (1, 2, 0))  # [B, W, Ltp]
        run = jnp.take_along_axis(lcp_w, idx[:, :, None].astype(jnp.int32),
                                  axis=2)[:, :, 0]
        return off + run.astype(jnp.int32)
    timeit("extend via transpose+gather", jax.jit(ext_gather), lcp, off)

    # pure compute step (no extension), one step
    @jax.jit
    def one_compute(state):
        active = jnp.ones((B,), dtype=bool)
        st, overflow = E._step_compute(cfg, dict(state), pat, txt, plen,
                                       tlen, frees, active)
        return st["offsets"], st["choices"]
    timeit("_step_compute (one step)", one_compute, state)

    # full body iteration cost: run the loop with max_steps=k for k steps
    def loop_n(n):
        ms = jnp.int32(n)
        f = jax.jit(functools.partial(E.align_batch, cfg))
        r = f(pat, txt, plen, tlen, frees, ms)
        jax.block_until_ready(r)
        t0 = time.time()
        for _ in range(ITERS):
            r = f(pat, txt, plen, tlen, frees, ms)
        jax.block_until_ready(r["status"])
        return (time.time() - t0) / ITERS * 1e6

    t4 = loop_n(4)
    t12 = loop_n(12)
    print(f"loop 4 steps  {t4:9.1f} us")
    print(f"loop 12 steps {t12:9.1f} us  -> per-step {(t12-t4)/8:9.1f} us")


if __name__ == "__main__":
    main()
