"""Long-read path: escalation ladder + engine/oracle agreement at kb scale."""
import random

import pytest

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.batch import align_pairs
from pywfa_tpu.oracle import OracleAligner
from pywfa_tpu.utils.check import check_alignment
from tests.corpus import set_mem_caps


def _ont_pair(rng, n, sub=0.04, ind=0.03):
    p = "".join(rng.choice("ACGT") for _ in range(n))
    out = []
    for c in p:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            out.append(rng.choice("ACGT"))
        out.append(c if rng.random() > sub else rng.choice("ACGT"))
    return p, "".join(out)


def test_3kb_escalation_matches_oracle():
    rng = random.Random(41)
    p, t = _ont_pair(rng, 3000)
    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    res = align_pairs(attr, [p.encode()], [t.encode()])[0]
    o = OracleAligner(attr).align(p.encode(), t.encode())
    assert (res.status, res.score) == (o.status, o.score)
    assert res.ops == o.ops
    check_alignment(res.ops, p, t, attr.penalties,
                    end_v=len(p), end_h=len(t))


def test_1kb_heuristic_adaptive():
    """BASELINE config #4: adaptive pruning on 1kb reads."""
    rng = random.Random(43)
    p, t = _ont_pair(rng, 1000)
    a = WavefrontAligner(p, heuristic="adaptive", span="ends-free",
                         backend="jax")
    res = a(t)
    b = WavefrontAligner(p, heuristic="adaptive", span="ends-free",
                         backend="numpy")
    res2 = b(t)
    assert res.status == res2.status
    assert res.score == res2.score
    assert res.cigartuples == res2.cigartuples


def test_4kb_remat_smoke(monkeypatch):
    """Fast smoke twin of the 10/20 kb remat tests (default tier): a 4kb
    pair with budgets forced far down so the remat machinery engages
    (multiple segments, snapshots, on-device replay walks), byte-equal to
    the oracle."""
    set_mem_caps(monkeypatch, 2 * 2**20, 8 * 2**20)
    rng = random.Random(777)
    p, t = _ont_pair(rng, 4000, sub=0.03, ind=0.02)
    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    res = align_pairs(attr, [p.encode()], [t.encode()])[0]
    o = OracleAligner(attr).align(p.encode(), t.encode())
    assert (res.status, res.score) == (o.status, o.score)
    assert res.ops == o.ops
    check_alignment(res.ops, p, t, attr.penalties,
                    end_v=len(p), end_h=len(t))


@pytest.mark.slow
def test_10kb_remat_matches_oracle(monkeypatch):
    """10kb ONT-style pairs through the rematerialized segmented path:
    byte-equal to the oracle with bounded device + host memory. Budgets
    forced down so the remat machinery actually engages
    (multiple segments, snapshots, on-device replay walks)."""
    set_mem_caps(monkeypatch, 8 * 2**20, 32 * 2**20)
    rng = random.Random(123)
    pairs = [_ont_pair(rng, 10000, sub=0.03, ind=0.02) for _ in range(2)]
    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    bp = [p.encode() for p, _ in pairs]
    bt = [t.encode() for _, t in pairs]
    res = align_pairs(attr, bp, bt)
    orc = OracleAligner(attr)
    for i in range(len(pairs)):
        o = orc.align(bp[i], bt[i])
        assert (res[i].status, res[i].score, res[i].ops) == \
            (o.status, o.score, o.ops), i
        check_alignment(res[i].ops, pairs[i][0], pairs[i][1], attr.penalties,
                        end_v=len(bp[i]), end_h=len(bt[i]))


@pytest.mark.slow
def test_20kb_remat_matches_oracle(monkeypatch):
    """20kb single pair, same bounded-memory path."""
    set_mem_caps(monkeypatch, 8 * 2**20, 32 * 2**20)
    rng = random.Random(321)
    p, t = _ont_pair(rng, 20000, sub=0.03, ind=0.02)
    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    res = align_pairs(attr, [p.encode()], [t.encode()])[0]
    o = OracleAligner(attr).align(p.encode(), t.encode())
    assert (res.status, res.score) == (o.status, o.score)
    assert res.ops == o.ops


@pytest.mark.slow
def test_50kb_remat_matches_oracle(monkeypatch):
    """50kb single pair through the segmented executor (the regime BiWFA's
    O(s) memory exists for, reference: wavefront_bialign.c:48-50): the
    tested anchor for PARITY.md's 50 kb claim. Low
    divergence keeps the oracle's scalar run tractable; budgets forced
    down so segmentation engages."""
    set_mem_caps(monkeypatch, 8 * 2**20, 64 * 2**20)
    rng = random.Random(555)
    p, t = _ont_pair(rng, 50000, sub=0.01, ind=0.01)
    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    res = align_pairs(attr, [p.encode()], [t.encode()])[0]
    o = OracleAligner(attr).align(p.encode(), t.encode())
    assert (res.status, res.score) == (o.status, o.score)
    assert res.ops == o.ops


def test_escalation_ladder_runs():
    """A divergent pair must climb rungs, not fail. 300 bp unrelated:
    the worst-case score (~700) still forces >= 2 escalation re-runs
    past the optimistic first rung (600 bp costs ~2 extra compiles
    ~100 s on CPU for the same invariant)."""
    rng = random.Random(47)
    p = "".join(rng.choice("ACGT") for _ in range(300))
    t = "".join(rng.choice("ACGT") for _ in range(300))  # unrelated
    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    res = align_pairs(attr, [p.encode()], [t.encode()])[0]
    o = OracleAligner(attr).align(p.encode(), t.encode())
    assert (res.status, res.score, res.ops) == (o.status, o.score, o.ops)
