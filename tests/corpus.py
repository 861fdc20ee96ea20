"""Shared random-pair corpus generators for the test suite.

One place for the mutate-a-pattern semantics (substitutions at rate `sub`;
for each base, delete with probability ind/2 or insert a random base with
probability ind/2) so tweaks apply suite-wide.
"""
import random


def mutate(rng: random.Random, p: str, sub: float, ind: float) -> str:
    t = []
    for c in p:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            t.append(rng.choice("ACGT"))
        t.append(c if rng.random() > sub else rng.choice("ACGT"))
    return "".join(t) or "A"


def random_pairs(seed, n, lo, hi, sub, ind, unrelated=0.0, as_bytes=False):
    """n (pattern, text) pairs; `unrelated` fraction get a fresh random
    text (forcing drops/escalation)."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        p = "".join(rng.choice("ACGT") for _ in range(rng.randint(lo, hi)))
        if unrelated and rng.random() < unrelated:
            t = "".join(rng.choice("ACGT")
                        for _ in range(rng.randint(lo, hi)))
        else:
            t = mutate(rng, p, sub, ind)
        out.append((p.encode(), t.encode()) if as_bytes else (p, t))
    return out


def set_mem_caps(monkeypatch, choices: int, replay_choices: int) -> None:
    """Shrink the device-memory budgets that decide segmentation (the
    rest keep their CPU values), forcing the segmented/remat path."""
    import dataclasses

    import pywfa_tpu.batch as batch_mod
    caps = dataclasses.replace(batch_mod.CPU_MEM_CAPS, choices=choices,
                               replay_choices=replay_choices)
    monkeypatch.setattr(batch_mod, "device_mem_caps", lambda: caps)


_EF = dict(span="ends-free", pattern_begin_free=6, pattern_end_free=6,
           text_begin_free=6, text_end_free=6)
_BONUS = dict(match=-3, mismatch=5, gap_opening=7, gap_extension=2)

# engine configurations compared with the oracle on the CPU
# (test_engine_configs.py) and on the GPU (test_gpu.py): (id,
# WavefrontAligner kwargs, HeuristicParams fields for strategies the pywfa
# API does not name; see chip_smoke.aligner_attributes)
ENGINE_CONFIGS = (
    ("end-to-end", dict(span="end-to-end"), None),
    ("ends-free", _EF, None),
    ("affine2p", dict(distance="affine2p", span="end-to-end"), None),
    ("affine2p-ends-free", dict(_EF, distance="affine2p"), None),
    ("linear", dict(distance="linear", span="end-to-end"), None),
    ("edit", dict(distance="levenshtein", span="end-to-end"), None),
    ("indel", dict(distance="indel", span="end-to-end"), None),
    ("match-bonus", dict(_BONUS, span="end-to-end"), None),
    ("match-bonus-ends-free", dict(_BONUS, **_EF), None),
    ("wf-adaptive", dict(span="end-to-end", heuristic="adaptive",
                         min_wavefront_length=5,
                         max_distance_threshold=15), None),
    ("match-classes", dict(span="end-to-end", match_classes="iupac"), None),
    ("wfmash", dict(span="end-to-end"),
     dict(strategy="WFMASH", min_wavefront_length=5,
          max_distance_threshold=12)),
    ("banded-static", dict(span="end-to-end"),
     dict(strategy="BANDED_STATIC", min_k=-12, max_k=12)),
    ("banded-adaptive", dict(span="end-to-end"),
     dict(strategy="BANDED_ADAPTIVE", min_k=-10, max_k=10,
          steps_between_cutoffs=2)),
    ("x-drop", dict(span="end-to-end", heuristic="X-drop", xdrop=10), None),
    ("z-drop", dict(span="end-to-end"), dict(strategy="ZDROP", zdrop=12)),
    ("score-only", dict(span="end-to-end", scope="score"), None),
)
