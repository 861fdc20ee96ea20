"""Cross-engine parity: batched JAX engine vs the scalar oracle.

Every (status, score, cigar-op string) must agree exactly between the two
independently-written engines across random workloads and configs.
"""
import random

import pytest

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.attributes import AlignerAttributes
from pywfa_tpu.batch import align_pairs
from pywfa_tpu.oracle import OracleAligner


def rand_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def mutate(rng, seq, sub_rate, indel_rate):
    out = []
    for c in seq:
        r = rng.random()
        if r < indel_rate / 2:
            continue
        if r < indel_rate:
            out.append(rng.choice("ACGT"))
        if rng.random() < sub_rate:
            out.append(rng.choice([b for b in "ACGT" if b != c]))
        else:
            out.append(c)
    return "".join(out)


def _compare(aligner_kwargs, pairs):
    api = WavefrontAligner(backend="numpy", **aligner_kwargs)
    attr = api._attributes()
    wc = api._bwildcard if api._wildcard else None
    bp = [p.encode() for p, _ in pairs]
    bt = [t.encode() for _, t in pairs]
    batch = align_pairs(attr, bp, bt, wildcard=wc)
    orc = OracleAligner(attr, wc)
    for i, (p, t) in enumerate(pairs):
        o = orc.align(bp[i], bt[i])
        b = batch[i]
        assert b.status == o.status, (i, p, t, b.status, o.status)
        assert b.score == o.score, (i, p, t, b.score, o.score)
        assert b.ops == o.ops, (i, p, t, b.ops, o.ops)


def _random_pairs(seed, n, min_len=8, max_len=120, sub=0.08, ind=0.06):
    rng = random.Random(seed)
    pairs = []
    for _ in range(n):
        p = rand_seq(rng, rng.randint(min_len, max_len))
        t = mutate(rng, p, sub, ind)
        if not t:
            t = "A"
        pairs.append((p, t))
    return pairs


@pytest.mark.parametrize("distance", ["affine", "affine2p", "linear",
                                      "levenshtein", "indel"])
def test_end2end_random(distance):
    pairs = _random_pairs(hash(distance) % 1000, 16)
    _compare(dict(distance=distance, span="end-to-end"), pairs)


@pytest.mark.parametrize("distance", ["affine", "affine2p"])
def test_endsfree_default_random(distance):
    # pywfa's default span: ends-free with all frees 0
    pairs = _random_pairs(42, 16)
    _compare(dict(distance=distance, span="ends-free"), pairs)


def test_endsfree_with_frees():
    pairs = _random_pairs(7, 12, min_len=30, max_len=90)
    _compare(dict(span="ends-free", pattern_begin_free=10,
                  pattern_end_free=10, text_begin_free=10,
                  text_end_free=10), pairs)


def test_negative_match_score():
    pairs = _random_pairs(11, 10, min_len=10, max_len=60)
    _compare(dict(match=-2, span="end-to-end"), pairs)
    _compare(dict(match=-1, span="ends-free", text_begin_free=5,
                  text_end_free=5, pattern_begin_free=5,
                  pattern_end_free=5), pairs)


def test_score_only():
    pairs = _random_pairs(13, 10)
    _compare(dict(scope="score", span="end-to-end"), pairs)


@pytest.mark.parametrize("mode", ["bits", "onehot", "onehot4", "table"])
def test_extension_mode_forced(mode, monkeypatch):
    # every extension formulation must satisfy the same byte contract
    # (PYWFA_EXTEND is captured into cfg.extend_force at config build)
    monkeypatch.setenv("PYWFA_EXTEND", mode)
    pairs = _random_pairs(700 + len(mode), 10)
    _compare(dict(distance="affine", span="end-to-end"), pairs)
    _compare(dict(distance="affine2p", span="ends-free",
                  pattern_begin_free=8, text_end_free=8), pairs[:5])


@pytest.mark.parametrize("heuristic", ["adaptive", "X-drop"])
def test_heuristics_random(heuristic):
    pairs = _random_pairs(17, 10, min_len=40, max_len=150, sub=0.15, ind=0.1)
    _compare(dict(heuristic=heuristic, span="end-to-end"), pairs)


def test_divergent_pairs():
    rng = random.Random(23)
    pairs = [(rand_seq(rng, rng.randint(10, 60)),
              rand_seq(rng, rng.randint(10, 60))) for _ in range(12)]
    _compare(dict(span="end-to-end"), pairs)
    _compare(dict(distance="affine2p", span="end-to-end"), pairs)


def test_extreme_length_ratio():
    rng = random.Random(29)
    pairs = [(rand_seq(rng, 100), rand_seq(rng, 9)),
             (rand_seq(rng, 9), rand_seq(rng, 100)),
             ("A", rand_seq(rng, 50)),
             (rand_seq(rng, 50), "A")]
    _compare(dict(span="end-to-end"), pairs)
    _compare(dict(span="ends-free"), pairs)


def test_max_steps_batch():
    rng = random.Random(31)
    pairs = [(rand_seq(rng, 80), rand_seq(rng, 80)) for _ in range(4)]
    _compare(dict(span="end-to-end", max_steps=10), pairs)


def test_wildcard_near_sequence_ends():
    """Regression: wildcard must not match sentinel padding (soak-found).

    A text 'N' adjacent to the pattern end previously extended past the
    pattern boundary, shifting the ends-free termination cell.
    """
    kw = dict(distance="levenshtein", span="ends-free",
              pattern_begin_free=14, pattern_end_free=2,
              text_begin_free=16, text_end_free=4, wildcard="N")
    p = "CAAAGCAACCAGTTGCAGAAGAAACTTAGG"
    t = "CGGCTTAAGAACTAAATATCCTTCAACNGAA"
    _compare(kw, [(p, t)])
    # wildcards at the very ends, both sides
    _compare(dict(wildcard="N", span="end-to-end"),
             [("ACGTN", "ACGTT"), ("NACGT", "TACGT"),
              ("ACGT", "ACGTN"), ("NNNN", "ACGT"), ("ACG", "ACGN")])


def test_endsfree_negative_match_with_xdrop():
    """Regression (soak-found): with match<0 + ends-free, the reference
    allocates an (empty) M wavefront on every match-multiple score even when
    no boundary seed applies, which keeps the heuristic cadence ticking; the
    engine previously treated those as absent wavefronts, desynchronizing
    X-drop and losing the optimal path."""
    kw = dict(distance="affine", span="ends-free", mismatch=6,
              gap_extension=4, gap_opening=3, match=-1,
              pattern_begin_free=6, pattern_end_free=0,
              text_begin_free=5, text_end_free=7, heuristic="X-drop",
              min_wavefront_length=14, max_distance_threshold=40,
              steps_between_cutoffs=2, xdrop=10)
    p = ("TCTTGACAGAAACCTTGTTTAGAGGCTTCCGAGAGTCCAAATCGGGCCGAGATTACGGTTTA"
         "TACTGCGTGACCGTATA")
    t = ("GCTTGACAGATACCTTGTTTAGAGACTACCGAGAGTCCAGATTGGGCGGAGGAATACGGTTT"
         "GTACCGCGTTGACCCGTATCA")
    _compare(kw, [(p, t)])
    # sweep a few more shapes of the same family
    kw2 = dict(kw, heuristic="adaptive", match=-2, steps_between_cutoffs=1)
    _compare(kw2, [(p, t), (p[:40], t[:50]), (t[:60], p[:30])])


def test_lcp_table_chunked_build_identical(monkeypatch):
    """The diagonal-chunked LCP-table build (big-band / long-read path,
    guards int32 addressing limits) must equal the one-shot build."""
    import numpy as np
    import jax.numpy as jnp
    from pywfa_tpu import batch as BT
    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu.attributes import validate_alignment
    from pywfa_tpu.ops import engine as E

    rng = np.random.default_rng(5)
    al = np.frombuffer(b"ACGT", np.uint8)
    B, L = 3, 700
    pats = [al[rng.integers(0, 4, rng.integers(300, L + 1))].tobytes()
            for _ in range(B)]
    txts = [al[rng.integers(0, 4, rng.integers(300, L + 1))].tobytes()
            for _ in range(B)]
    attr = validate_alignment(
        WavefrontAligner(backend="numpy", span="end-to-end")._attributes(),
        L, L)
    cfg = E.full_config(attr, L, L, W=1536, S_cap=64)
    C = cfg.extend_chunk
    pat = jnp.asarray(BT.encode_batch(pats, cfg.Lp, C, BT.PATTERN_SENTINEL))
    txt = jnp.asarray(BT.encode_batch(txts, cfg.Lt, C, BT.TEXT_SENTINEL))
    ref = np.asarray(E._build_lcp_table(cfg, pat, txt))
    monkeypatch.setattr(E, "LCP_BUILD_ELEMS_CAP", 2**20)  # force chunking
    got = np.asarray(E._build_lcp_table(cfg, pat, txt))
    np.testing.assert_array_equal(got, ref)
