"""The engine against the oracle on the GPU, across metric x span x
heuristic (tests/corpus.ENGINE_CONFIGS) at the 150 bp x 4096 batch of
chip_smoke.py phase 3, plus its 1 kb and 10 kb shapes.

    JAX_PLATFORMS= python -m pytest tests/test_gpu.py -m gpu -q -p no:cacheprovider

(an explicit empty JAX_PLATFORMS keeps tests/conftest.py from forcing the
CPU). Every test skips unless JAX's default device is a GPU.
"""
import numpy as np
import pytest

import chip_smoke
from pywfa_tpu.batch import align_pairs
from tests.corpus import ENGINE_CONFIGS

pytestmark = pytest.mark.gpu

SHORT = chip_smoke.CASES[0]
LONG = [c for c in chip_smoke.CASES if c.length >= 1000 and not c.segmented]


@pytest.fixture
def gpu():
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {platform!r}")


def _run(attr, wc, n, length, div, n_oracle, seed):
    rng = np.random.default_rng(seed)
    pats, txts = chip_smoke.make_pairs(rng, n, length, div)
    res = align_pairs(attr, pats, txts, wildcard=wc)
    assert len(res) == n
    assert chip_smoke.oracle_mismatches(attr, pats, txts, res, n_oracle,
                                        wc) == []


@pytest.mark.parametrize("name,kw,hparams", ENGINE_CONFIGS,
                         ids=[c[0] for c in ENGINE_CONFIGS])
def test_config_matches_oracle_150bp(gpu, name, kw, hparams):
    attr, wc = chip_smoke.aligner_attributes(kw, hparams)
    _run(attr, wc, SHORT.n, SHORT.length, SHORT.div, 256,
         sum(map(ord, name)))


@pytest.mark.parametrize("case", LONG, ids=[c.name for c in LONG])
def test_long_reads_match_oracle(gpu, case):
    _run(chip_smoke.attributes(case), None, case.n, case.length, case.div,
         case.n_oracle, case.length)
