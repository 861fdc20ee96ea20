"""Fuzz the engine-native partial/dropped/extension paths vs the oracle.

Asserts byte-parity of (status, score, ops, end_v, end_h, dropped) and
reports how many pairs needed the oracle fallback (should be ~zero).
Run on CPU: JAX_PLATFORMS=cpu python tools/fuzz_partials.py [seed0 n_iters]
"""
import dataclasses
import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")
# CPU runs skip the persistent compile cache (XLA:CPU AOT
# (de)serialization can segfault; see tests/conftest.py)
jax.config.update("jax_enable_compilation_cache", False)

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.attributes import HeuristicParams
from pywfa_tpu import batch as B
from pywfa_tpu.constants import HeuristicStrategy
from pywfa_tpu.oracle import OracleAligner

FALLBACKS = 0
_orig = B._oracle_one


def _counting_oracle(attr, pattern, text, wildcard):
    global FALLBACKS
    FALLBACKS += 1
    if os.environ.get("FUZZ_VERBOSE"):
        print(f"FALLBACK len={len(pattern)}/{len(text)} "
              f"strat={int(attr.heuristic.strategy)} "
              f"metric={attr.penalties.distance_metric} "
              f"span={attr.form.span} ext={attr.form.extension} "
              f"P={pattern.decode()} T={text.decode()}")
    return _orig(attr, pattern, text, wildcard)


B._oracle_one = _counting_oracle


def mutate(rng, p, sub, ind):
    t = []
    for c in p:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            t.append(rng.choice("ACGT"))
        t.append(c if rng.random() > sub else rng.choice("ACGT"))
    return "".join(t) or "A"


def run(seed):
    rng = random.Random(seed)
    n = 16
    sub = rng.choice([0.05, 0.15, 0.3, 0.5])
    ind = rng.choice([0.02, 0.1, 0.25])
    pairs = []
    for _ in range(n):
        L = rng.randint(30, 200)
        p = "".join(rng.choice("ACGT") for _ in range(L))
        if rng.random() < 0.15:
            # unrelated pair (forces early drops)
            t = "".join(rng.choice("ACGT") for _ in range(rng.randint(30, 200)))
        else:
            t = mutate(rng, p, sub, ind)
        pairs.append((p, t))

    strat = rng.choice([
        HeuristicParams(strategy=HeuristicStrategy.ZDROP,
                        zdrop=rng.choice([5, 15, 40]),
                        steps_between_cutoffs=rng.choice([1, 2])),
        HeuristicParams(strategy=HeuristicStrategy.XDROP,
                        xdrop=rng.choice([5, 15, 40]),
                        steps_between_cutoffs=rng.choice([1, 2])),
        HeuristicParams(strategy=(HeuristicStrategy.WFADAPTIVE
                                  | HeuristicStrategy.ZDROP),
                        min_wavefront_length=5, max_distance_threshold=20,
                        zdrop=rng.choice([10, 25]), steps_between_cutoffs=1),
        HeuristicParams(strategy=(HeuristicStrategy.BANDED_STATIC
                                  | HeuristicStrategy.ZDROP),
                        min_k=-15, max_k=15, zdrop=15,
                        steps_between_cutoffs=1),
    ])
    span = rng.choice(["end-to-end", "ends-free"])
    scope = rng.choice(["full", "full", "score"])
    kw = dict(span=span, scope=scope)
    if span == "ends-free":
        kw.update(pattern_begin_free=10, pattern_end_free=10,
                  text_begin_free=10, text_end_free=10)
    distance = rng.choice(["affine", "affine2p", "levenshtein"])
    if distance == "levenshtein":
        strat = dataclasses.replace(strat, strategy=HeuristicStrategy.WFADAPTIVE,
                                    min_wavefront_length=5,
                                    max_distance_threshold=20)
    api = WavefrontAligner(backend="numpy", distance=distance, **kw)
    attr = dataclasses.replace(api._attributes(), heuristic=strat)
    bp = [p.encode() for p, _ in pairs]
    bt = [t.encode() for _, t in pairs]
    res = B.align_pairs(attr, bp, bt)
    orc = OracleAligner(attr)
    bad = 0
    for i in range(n):
        o = orc.align(bp[i], bt[i])
        b = res[i]
        got = (b.status, b.score, b.ops, b.end_v, b.end_h, b.dropped)
        want = (o.status, o.score, o.ops, o.end_v, o.end_h, o.dropped)
        if got != want:
            bad += 1
            print(f"MISMATCH seed={seed} i={i} strat={strat.strategy} "
                  f"dist={distance} span={span} scope={scope}")
            print(f"  P={pairs[i][0]}")
            print(f"  T={pairs[i][1]}")
            print(f"  got  {got}")
            print(f"  want {want}")
    return bad


def run_extension(seed):
    rng = random.Random(seed + 777)
    pairs = []
    for _ in range(8):
        L = rng.randint(30, 150)
        p = "".join(rng.choice("ACGT") for _ in range(L))
        t = mutate(rng, p, 0.2, 0.1)
        # random flank garbage so maxtrim has something to trim
        t = t + "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 40)))
        pairs.append((p, t))
    api = WavefrontAligner(backend="numpy", span="ends-free",
                           pattern_begin_free=0, pattern_end_free=1,
                           text_begin_free=0, text_end_free=1)
    attr = api._attributes()
    attr = dataclasses.replace(attr, form=dataclasses.replace(
        attr.form, extension=True))
    bp = [p.encode() for p, _ in pairs]
    bt = [t.encode() for _, t in pairs]
    res = B.align_pairs(attr, bp, bt)
    orc = OracleAligner(attr)
    bad = 0
    for i in range(len(pairs)):
        o = orc.align(bp[i], bt[i])
        b = res[i]
        got = (b.status, b.score, b.ops, b.end_v, b.end_h, b.dropped)
        want = (o.status, o.score, o.ops, o.end_v, o.end_h, o.dropped)
        if got != want:
            bad += 1
            print(f"EXT MISMATCH seed={seed} i={i}")
            print(f"  P={pairs[i][0]}")
            print(f"  T={pairs[i][1]}")
            print(f"  got  {got}")
            print(f"  want {want}")
    return bad


if __name__ == "__main__":
    seed0 = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 40
    total_bad = 0
    for s in range(seed0, seed0 + iters):
        total_bad += run(s)
        total_bad += run_extension(s)
    print(f"done: {iters} iters, mismatches={total_bad}, "
          f"oracle_fallbacks={FALLBACKS}")
    sys.exit(1 if total_bad else 0)
