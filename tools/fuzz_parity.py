#!/usr/bin/env python
"""Cross-engine parity fuzzer: random configs x random pairs.

Runs the batched JAX engine against the NumPy oracle on randomized
configurations (metric, penalties, span, frees, heuristics, match scores,
wildcards, memory modes) and asserts byte-equality of (status, score, ops).
Not part of the default test suite; run ad hoc:

    python tools/fuzz_parity.py [n_iters] [seed]

Any failure prints a minimal repro dict and exits nonzero.
"""
import json
import random
import sys

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")
# CPU runs skip the persistent compile cache (XLA:CPU AOT
# (de)serialization can segfault; see tests/conftest.py)
jax.config.update("jax_enable_compilation_cache", False)

from pywfa_tpu.align import WavefrontAligner  # noqa: E402
from pywfa_tpu.batch import align_pairs  # noqa: E402
from pywfa_tpu.oracle import OracleAligner  # noqa: E402


def rand_seq(rng, n):
    return "".join(rng.choice("ACGTN") if rng.random() < 0.02
                   else rng.choice("ACGT") for _ in range(n))


def mutate(rng, seq, sub, ind):
    out = []
    for c in seq:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            out.append(rng.choice("ACGT"))
        out.append(c if rng.random() > sub else rng.choice("ACGT"))
    return "".join(out) or "A"


def random_config(rng):
    distance = rng.choice(["affine", "affine", "affine", "affine2p",
                           "linear", "levenshtein", "indel"])
    kw = dict(distance=distance)
    kw["span"] = rng.choice(["end-to-end", "ends-free", "ends-free"])
    if distance in ("affine", "affine2p", "linear"):
        kw["mismatch"] = rng.randint(1, 8)
        kw["gap_extension"] = rng.randint(1, 4)
        if distance != "linear":
            kw["gap_opening"] = rng.randint(0, 12)
        if distance == "affine2p":
            kw["gap_opening2"] = rng.randint(10, 40)
            kw["gap_extension2"] = rng.randint(1, 2)
        if rng.random() < 0.25 and distance != "linear":
            kw["match"] = -rng.randint(1, 3)
    if kw["span"] == "ends-free" and rng.random() < 0.6:
        kw["pattern_begin_free"] = rng.randint(0, 20)
        kw["pattern_end_free"] = rng.randint(0, 20)
        kw["text_begin_free"] = rng.randint(0, 20)
        kw["text_end_free"] = rng.randint(0, 20)
    if rng.random() < 0.25 and distance in ("affine", "affine2p", "linear"):
        kw["heuristic"] = rng.choice(["adaptive", "X-drop"])
        kw["min_wavefront_length"] = rng.randint(1, 15)
        kw["max_distance_threshold"] = rng.randint(5, 60)
        kw["steps_between_cutoffs"] = rng.randint(1, 4)
        kw["xdrop"] = rng.randint(5, 40)
    if rng.random() < 0.1:
        kw["wildcard"] = "N"
    if rng.random() < 0.1:
        kw["max_steps"] = rng.randint(3, 50)
    if rng.random() < 0.2:
        kw["scope"] = "score"
    kw["memory_mode"] = rng.choice(["high", "high", "medium", "low", "biwfa"])
    return kw


def run_iter(rng, it):
    kw = random_config(rng)
    n = rng.randint(2, 10)
    pairs = []
    for _ in range(n):
        mode = rng.random()
        if mode < 0.6:
            p = rand_seq(rng, rng.randint(2, 150))
            t = mutate(rng, p, rng.uniform(0, 0.25), rng.uniform(0, 0.15))
        elif mode < 0.8:
            p = rand_seq(rng, rng.randint(2, 100))
            t = rand_seq(rng, rng.randint(2, 100))
        else:
            base = rand_seq(rng, rng.randint(5, 60))
            p = rand_seq(rng, rng.randint(0, 10)) + base
            t = base + rand_seq(rng, rng.randint(0, 10))
        pairs.append((p, t))
    api = WavefrontAligner(backend="numpy", **kw)
    attr = api._attributes()
    wc = api._bwildcard if api._wildcard else None
    bp = [p.encode() for p, _ in pairs]
    bt = [t.encode() for _, t in pairs]
    try:
        batch = align_pairs(attr, bp, bt, wildcard=wc)
    except Exception as e:
        print(f"ENGINE EXCEPTION iter={it} kw={json.dumps(kw)}")
        print("pairs:", pairs)
        raise
    import dataclasses as _dc
    for i, (p, t) in enumerate(pairs):
        # batch mode clamps ends-free slack per pair (C would abort the
        # process); clamp the same way for the oracle comparison
        f = attr.form
        attr_i = _dc.replace(attr, form=_dc.replace(
            f,
            pattern_begin_free=min(f.pattern_begin_free, len(p)),
            pattern_end_free=min(f.pattern_end_free, len(p)),
            text_begin_free=min(f.text_begin_free, len(t)),
            text_end_free=min(f.text_end_free, len(t))))
        o = OracleAligner(attr_i, wc).align(bp[i], bt[i])
        b = batch[i]
        if (b.status, b.score, b.ops) != (o.status, o.score, o.ops):
            print("MISMATCH", json.dumps({
                "iter": it, "kw": kw, "pattern": p, "text": t,
                "engine": [b.status, b.score, b.ops],
                "oracle": [o.status, o.score, o.ops],
            }))
            return False
    return True


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = random.Random(seed)
    fails = 0
    for it in range(iters):
        if not run_iter(rng, it):
            fails += 1
            if fails >= 5:
                break
        if (it + 1) % 20 == 0:
            print(f"... {it + 1}/{iters} ok={it + 1 - fails}", flush=True)
            jax.clear_caches()  # bound compile-cache memory across configs
    print(f"DONE {iters} iters, {fails} failures")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
