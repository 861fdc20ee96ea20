"""Segmented execution with rematerialized traceback must match one-shot
results (bounded device AND host memory; see batch._align_pairs_remat)."""
import random

import numpy as np

import pywfa_tpu.batch as batch_mod
from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.batch import align_pairs
from pywfa_tpu.oracle import OracleAligner
from tests.corpus import set_mem_caps


def _pairs(seed, n, lo, hi, sub=0.08, ind=0.06):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        p = "".join(rng.choice("ACGT") for _ in range(rng.randint(lo, hi)))
        t = []
        for c in p:
            r = rng.random()
            if r < ind / 2:
                continue
            if r < ind:
                t.append(rng.choice("ACGT"))
            t.append(c if rng.random() > sub else rng.choice("ACGT"))
        out.append((p, "".join(t) or "A"))
    return out


def test_segmented_matches_oneshot(monkeypatch):
    pairs = _pairs(3, 8, 60, 160)
    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    bp = [p.encode() for p, _ in pairs]
    bt = [t.encode() for _, t in pairs]
    ref = align_pairs(attr, bp, bt)
    # force the remat path with tiny budgets (multiple 64-step segments)
    set_mem_caps(monkeypatch, 1, 1)
    seg = align_pairs(attr, bp, bt)
    for i, (r, s) in enumerate(zip(ref, seg)):
        assert (r.status, r.score, r.ops) == (s.status, s.score, s.ops), i


def test_segmented_matches_oracle_divergent(monkeypatch):
    rng = random.Random(9)
    pairs = [("".join(rng.choice("ACGT") for _ in range(120)),
              "".join(rng.choice("ACGT") for _ in range(100)))
             for _ in range(4)]
    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    bp = [p.encode() for p, _ in pairs]
    bt = [t.encode() for _, t in pairs]
    set_mem_caps(monkeypatch, 1, 1)
    seg = align_pairs(attr, bp, bt)
    orc = OracleAligner(attr)
    for i in range(len(pairs)):
        o = orc.align(bp[i], bt[i])
        assert (seg[i].status, seg[i].score, seg[i].ops) == \
            (o.status, o.score, o.ops), i


def test_segmentation_follows_memory_caps(monkeypatch):
    """Segmentation is decided by the device-memory budget alone: a
    choices tensor over MemCaps.choices goes segmented, one under it runs
    one-shot (and both give the same results)."""
    calls = []
    real = batch_mod._align_pairs_remat

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(batch_mod, "_align_pairs_remat", spy)
    pairs = _pairs(11, 4, 60, 100)
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    bp = [p.encode() for p, _ in pairs]
    bt = [t.encode() for _, t in pairs]
    ref = align_pairs(attr, bp, bt)
    assert not calls
    set_mem_caps(monkeypatch, 1, 1)
    seg = align_pairs(attr, bp, bt)
    assert calls
    for r, s in zip(ref, seg):
        assert (r.status, r.score, r.ops) == (s.status, s.score, s.ops)
