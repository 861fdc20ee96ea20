"""Every engine configuration through batch.align_pairs against the scalar
oracle on (status, score, CIGAR): metrics, spans, the match bonus, class
matching, every heuristic strategy and score-only scope."""
import pytest

from chip_smoke import aligner_attributes, oracle_mismatches
from pywfa_tpu.batch import align_pairs
from tests.corpus import ENGINE_CONFIGS, random_pairs


@pytest.mark.parametrize("name,kw,hparams", ENGINE_CONFIGS,
                         ids=[c[0] for c in ENGINE_CONFIGS])
def test_config_matches_oracle(name, kw, hparams):
    attr, wc = aligner_attributes(kw, hparams)
    drops = hparams is not None or "heuristic" in kw
    pairs = random_pairs(sum(map(ord, name)), 8, 30, 150,
                         sub=0.2 if drops else 0.08,
                         ind=0.15 if drops else 0.06, as_bytes=True)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    res = align_pairs(attr, pats, txts, wildcard=wc)
    assert oracle_mismatches(attr, pats, txts, res, len(pairs), wc) == []
