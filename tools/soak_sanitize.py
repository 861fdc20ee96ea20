#!/usr/bin/env python
"""Sanitizer-analog stress soak (the ASan/UBSan build's moral equivalent,
reference: pywfa/WFA2_lib/Makefile:53-59).

A managed-runtime engine has no wild pointers to catch, so the analogous
failure classes here are silent numeric corruption and inconsistent
outputs. This soak enables every runtime guard the stack offers and runs
the parity fuzz corpus under them:

  - jax_enable_checks: JAX-internal invariant checking on every op
  - jax_debug_nans / jax_debug_infs: trap non-finite values in the float
    stages (e.g. the one-hot-matmul op-stream compaction)
  - numpy seterr(all='raise'): host-side numeric traps
  - full self-check of every produced CIGAR against the sequences
    (utils.check.check_alignment -- the reference's
    system.check_alignment_correct, wavefront_debug.c:40-119)

Usage: python tools/soak_sanitize.py [seed0 n_iters]   (CPU, ~2 min default)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# CPU runs skip the persistent compile cache (XLA:CPU AOT
# (de)serialization can segfault; see tests/conftest.py)
jax.config.update("jax_enable_compilation_cache", False)
jax.config.update("jax_enable_checks", True)
jax.config.update("jax_debug_nans", True)
jax.config.update("jax_debug_infs", True)

import numpy as np  # noqa: E402

np.seterr(all="raise")


def main():
    seed0 = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    n_iters = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    import random

    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu import batch as B
    from pywfa_tpu.utils.check import check_alignment

    rng0 = random.Random(seed0)
    checked = 0
    for it in range(n_iters):
        rng = random.Random(seed0 * 1000 + it)
        n = 24
        pairs = []
        for _ in range(n):
            L = rng.randint(20, 200)
            p = "".join(rng.choice("ACGT") for _ in range(L))
            t = []
            for c in p:
                r = rng.random()
                if r < 0.04:
                    continue
                if r < 0.08:
                    t.append(rng.choice("ACGT"))
                t.append(c if rng.random() > 0.1 else rng.choice("ACGT"))
            pairs.append((p, "".join(t) or "A"))
        span = rng.choice(["end-to-end", "ends-free"])
        kw = dict(span=span)
        if span == "ends-free":
            kw.update(pattern_begin_free=15, pattern_end_free=15,
                      text_begin_free=15, text_end_free=15)
        dist = rng.choice(["affine", "affine2p", "linear"])
        attr = WavefrontAligner(backend="numpy", distance=dist,
                                **kw)._attributes()
        res = B.align_pairs(attr, [p.encode() for p, _ in pairs],
                            [t.encode() for _, t in pairs])
        for (p, t), r in zip(pairs, res):
            if r.status == 0 and r.ops:
                # completed full CIGARs consume both sequences fully
                # (frees are explicit I/D ops)
                check_alignment(r.ops, p, t, attr.penalties,
                                end_v=len(p), end_h=len(t))
                checked += 1
        if (it + 1) % 10 == 0:
            print(f"iter {it + 1}/{n_iters}: {checked} CIGARs "
                  "self-checked under sanitizer guards", flush=True)
    print(f"soak_sanitize OK: {n_iters} iters, {checked} CIGARs checked, "
          "no traps fired")


if __name__ == "__main__":
    main()
