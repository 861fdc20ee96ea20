"""Engine-native partial/dropped/extension CIGARs (no oracle fallback).

The reference backtraces z-dropped alignments from the historic-max cell and
maxtrims them (wavefront_unialign.c:211-235); heuristic dead-ends report an
empty PARTIAL; extension mode maxtrims completed alignments
(wavefront_align.c:57-63). Round 2 re-ran all of these through the scalar
oracle; these tests pin the engine-native paths byte-equal to the oracle AND
assert the oracle is never invoked (killing the false-drop blind spot:
an engine that wrongly drops can no longer hide behind the fallback).
"""
import dataclasses
import random

import pytest

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.attributes import HeuristicParams
from pywfa_tpu import batch as B
from pywfa_tpu.constants import HeuristicStrategy
from pywfa_tpu.oracle import OracleAligner


from tests.corpus import mutate as _mutate, random_pairs


def _pairs(seed, n, sub, ind, unrelated=0.2, lo=40, hi=180):
    return random_pairs(seed, n, lo, hi, sub, ind, unrelated=unrelated,
                        as_bytes=True)


@pytest.fixture
def no_oracle(monkeypatch):
    """Fail the test if any pair falls back to the scalar oracle."""
    def boom(*a, **k):
        raise AssertionError("oracle fallback invoked")
    monkeypatch.setattr(B, "_oracle_one", boom)


def _attr(heur=None, distance="affine", scope="full", span="end-to-end",
          **kw):
    api = WavefrontAligner(backend="numpy", distance=distance, scope=scope,
                          span=span, **kw)
    attr = api._attributes()
    if heur is not None:
        attr = dataclasses.replace(attr, heuristic=heur)
    return attr


def _check_parity(attr, pairs):
    res = B.align_pairs(attr, [p for p, _ in pairs], [t for _, t in pairs])
    orc = OracleAligner(attr)
    n_dropped = 0
    for i, (p, t) in enumerate(pairs):
        o = orc.align(p, t)
        b = res[i]
        assert (b.status, b.score, b.ops, b.end_v, b.end_h, b.dropped) == \
            (o.status, o.score, o.ops, o.end_v, o.end_h, o.dropped), \
            (i, p, t)
        n_dropped += b.dropped
    return n_dropped


@pytest.mark.parametrize("distance", ["affine", "affine2p"])
@pytest.mark.parametrize("scope", ["full", "score"])
def test_zdrop_native(no_oracle, distance, scope):
    h = HeuristicParams(strategy=HeuristicStrategy.ZDROP, zdrop=15,
                        steps_between_cutoffs=1)
    attr = _attr(h, distance=distance, scope=scope)
    n_dropped = _check_parity(attr, _pairs(11, 24, sub=0.35, ind=0.15))
    assert n_dropped >= 4  # the corpus must actually exercise drops


def test_zdrop_endsfree_native(no_oracle):
    h = HeuristicParams(strategy=HeuristicStrategy.ZDROP, zdrop=10,
                        steps_between_cutoffs=2)
    attr = _attr(h, span="ends-free", pattern_begin_free=12,
                 pattern_end_free=12, text_begin_free=12, text_end_free=12)
    n_dropped = _check_parity(attr, _pairs(12, 16, sub=0.5, ind=0.25))
    assert n_dropped >= 3


def test_xdrop_deadend_native(no_oracle):
    """X-drop prunes to extinction -> END_UNREACHABLE with no end position;
    the reference reports an empty ALG_PARTIAL (dropped)."""
    h = HeuristicParams(strategy=HeuristicStrategy.XDROP, xdrop=8,
                        steps_between_cutoffs=1)
    attr = _attr(h)
    n_dropped = _check_parity(attr, _pairs(13, 16, sub=0.4, ind=0.2,
                                           unrelated=0.5))
    assert n_dropped >= 3


def test_wfadaptive_deadend_native(no_oracle):
    """WF-adaptive can strand the wavefront (num_null_steps dead-end)."""
    h = HeuristicParams(strategy=HeuristicStrategy.WFADAPTIVE,
                        min_wavefront_length=3, max_distance_threshold=8,
                        steps_between_cutoffs=1)
    attr = _attr(h)
    _check_parity(attr, _pairs(14, 16, sub=0.3, ind=0.2, unrelated=0.4))


def test_extension_mode_native(no_oracle):
    """WF-extend mode: ends-free preset + maxtrim of completed alignments
    (reference: wavefront_align.c:57-63, wavefront_unialign.c:211-227)."""
    rng = random.Random(15)
    pairs = []
    for _ in range(12):
        p = "".join(rng.choice("ACGT") for _ in range(rng.randint(40, 150)))
        t = _mutate(rng, p, 0.25, 0.1) + "".join(
            rng.choice("ACGT") for _ in range(rng.randint(0, 50)))
        pairs.append((p.encode(), t.encode()))
    api = WavefrontAligner(backend="numpy", span="ends-free",
                           pattern_begin_free=0, pattern_end_free=1,
                           text_begin_free=0, text_end_free=1)
    attr = api._attributes()
    attr = dataclasses.replace(attr, form=dataclasses.replace(
        attr.form, extension=True))
    res = B.align_pairs(attr, [p for p, _ in pairs], [t for _, t in pairs])
    orc = OracleAligner(attr)
    n_partial = 0
    for i, (p, t) in enumerate(pairs):
        o = orc.align(p, t)
        b = res[i]
        assert (b.status, b.score, b.ops, b.end_v, b.end_h, b.dropped) == \
            (o.status, o.score, o.ops, o.end_v, o.end_h, o.dropped), (i, p, t)
        n_partial += b.status == 1
    assert n_partial >= 2  # trims must actually occur


_DROP_GRID = [
        HeuristicParams(strategy=HeuristicStrategy.ZDROP, zdrop=15,
                        steps_between_cutoffs=1),
        HeuristicParams(strategy=HeuristicStrategy.XDROP, xdrop=15,
                        steps_between_cutoffs=2),
        HeuristicParams(strategy=(HeuristicStrategy.WFADAPTIVE
                                  | HeuristicStrategy.ZDROP),
                        min_wavefront_length=5, max_distance_threshold=20,
                        zdrop=25, steps_between_cutoffs=1),
        HeuristicParams(strategy=(HeuristicStrategy.BANDED_STATIC
                                  | HeuristicStrategy.ZDROP),
                        min_k=-15, max_k=15, zdrop=15,
                        steps_between_cutoffs=1),
        HeuristicParams(strategy=(HeuristicStrategy.WFADAPTIVE
                                  | HeuristicStrategy.XDROP),
                        min_wavefront_length=5, max_distance_threshold=20,
                        xdrop=10, steps_between_cutoffs=1),
    ]


def _run_drop_grid(per_config: int):
    """Pairs across the pruning-x-drop strategy grid must complete with
    ZERO oracle fallbacks (the mid-walk dead-end tail is pinned at zero;
    a regression that sends drops back to the host oracle fails loudly
    via the no_oracle fixture)."""
    total = 0
    n_dropped = 0
    for ci, h in enumerate(_DROP_GRID):
        attr = _attr(h, distance=("affine2p" if ci % 2 else "affine"))
        pairs = _pairs(100 + ci, per_config, sub=0.25, ind=0.08,
                       unrelated=0.25, lo=50, hi=170)
        res = B.align_pairs(attr, [p for p, _ in pairs],
                            [t for _, t in pairs])
        total += len(res)
        n_dropped += sum(r.dropped for r in res)
        assert all(r.status in (0, 1) for r in res)
    # the corpus must actually exercise the drop paths, heavily
    assert n_dropped > total // 4, n_dropped
    return total


def test_drop_corpus_smoke_zero_fallback(no_oracle):
    """Fast smoke twin of the 10k corpus: same strategy grid, 128
    pairs/config, zero oracle fallbacks (in the default test tier)."""
    assert _run_drop_grid(128) >= 512


@pytest.mark.slow
def test_drop_corpus_10k_zero_fallback(no_oracle):
    """Full 10k-pair corpus (slow tier; the 1k smoke above pins the same
    invariant per-commit)."""
    assert _run_drop_grid(2048) >= 10_000


def test_zdrop_big_batch_no_fallback(no_oracle):
    """A high-divergence batch with z-drop completes with zero oracle calls
    (scaled down for CI)."""
    h = HeuristicParams(strategy=HeuristicStrategy.ZDROP, zdrop=20,
                        steps_between_cutoffs=1)
    attr = _attr(h)
    pairs = _pairs(16, 64, sub=0.3, ind=0.1, unrelated=0.3, lo=60, hi=150)
    res = B.align_pairs(attr, [p for p, _ in pairs], [t for _, t in pairs])
    assert sum(r.dropped for r in res) >= 10
    assert all(r.status in (0, 1) for r in res)
