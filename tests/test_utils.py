"""Utils: IO, encode, plot, profiler, self-check, verbose API."""
import io
import os
import tempfile

import numpy as np
import pytest

from pywfa_tpu import WavefrontAligner
from pywfa_tpu.utils.check import check_alignment
from pywfa_tpu.utils.encode import pack2bits, unpack2bits
from pywfa_tpu.utils.io import read_fasta, read_fastx, write_fasta
from pywfa_tpu.utils.plot import plot_alignment
from pywfa_tpu.utils.profiler import Counter, Timer


def test_pack_roundtrip():
    for seq in (b"ACGT", b"A", b"ACGTACGTACG", b"TTTTTTT"):
        assert unpack2bits(pack2bits(seq), len(seq)) == seq
    with pytest.raises(ValueError):
        pack2bits(b"ACGN")


def test_packed_batch_align():
    from pywfa_tpu.batch import BatchWavefrontAligner
    pats = [b"ACGTACGTAAACGT", b"TTTTACGT"]
    txts = [b"ACGTACGTAATCGT", b"TTTTACGT"]
    ba = BatchWavefrontAligner(span="end-to-end")
    res = ba.align_packed2bits([pack2bits(p) for p in pats],
                               [len(p) for p in pats],
                               [pack2bits(t) for t in txts],
                               [len(t) for t in txts])
    assert res[0].score == -4 and res[1].score == 0


def test_fasta_io(tmp_path):
    path = str(tmp_path / "x.fa")
    write_fasta(path, [("s1", "ACGT" * 30), ("s2 extra", "TTTT")])
    recs = list(read_fasta(path))
    assert recs[0][1] == "ACGT" * 30
    assert len(recs) == 2


def test_fastq_io(tmp_path):
    path = str(tmp_path / "x.fq")
    with open(path, "w") as fh:
        fh.write("@r1 comment\nACGT\n+\nIIII\n@r2\nTTGG\n+\n!!!!\n")
    recs = list(read_fastx(path))
    assert recs[0].name == "r1" and recs[0].sequence == "ACGT"
    assert recs[0].quality == "IIII"
    assert recs[1].name == "r2"


def test_plot():
    p = plot_alignment("TCTTTACTCGCGCGTTGGAGAAATACAATAGT",
                       "TCTATACTGCGCGTTTGGAGAAATAAAATAGT",
                       span="end-to-end")
    assert len(p.steps) > 5
    txt = p.to_text()
    assert "." in txt or any(c.isdigit() for c in txt)
    grid = p.to_grid()
    assert (grid >= 0).any()


def test_plot_components_affine2p():
    # per-component heatmaps (reference: wavefront_plot.h:55-66) on an
    # affine2p pair with indels so I/D wavefronts materialize
    import io
    # a 12-base deletion engages the gap2 components (score reaches past
    # o2+e2=25, so I2/D2 wavefronts materialize)
    p = plot_alignment("TCTTTACTCGCGCGTTGGAGAAATACAATAGTCCGGTTAA",
                       "TCTATACTGCGCGTTTGGAGTCCGGTTAG",
                       span="end-to-end", distance="affine2p")
    for comp in ("I1", "D1", "I2", "D2"):
        assert len(p.comp_steps[comp]) > 0, comp
        # gap heatmaps render (I/D bands are sparse; grid may still have
        # visited cells for at least I1/D1)
        p.to_grid(comp)
    assert (p.to_grid("I1") >= 0).any()
    assert (p.to_grid("D1") >= 0).any()
    # behavior heatmap: both compute- and extend-reached cells exist
    bg = p.behavior_grid()
    assert (bg == 1).any() and (bg == 2).any()
    buf = io.StringIO()
    p.print_plot(buf)
    out = buf.getvalue()
    for section in ("# Heatmap M", "# Heatmap I1", "# Heatmap D2",
                    "# Heatmap Behavior"):
        assert section in out


def test_check_alignment_endsfree_trailing_frees():
    # regression (found by tools/soak_sanitize.py): check_alignment=True
    # misfired on ends-free alignments with trailing free indels -- the
    # CIGAR consumes both sequences fully (frees are explicit ops) while
    # end_v/end_h mark the pre-trailing alignment end
    from pywfa_tpu.align import WavefrontAligner
    a = WavefrontAligner(pattern="ACGTACGTACGTACGTAAAA", span="ends-free",
                         pattern_begin_free=5, pattern_end_free=5,
                         text_begin_free=5, text_end_free=5,
                         backend="numpy", check_alignment=True)
    r = a("ACGTACGTACGTACGT")
    assert r.score == 0 and a.cigarstring == "16M4D"


def test_sanitizer_soak_smoke():
    # the ASan-analog stress config (tools/soak_sanitize.py), 2 quick
    # iterations in-process so CI exercises the guard combination
    import subprocess
    import sys as _sys
    import os as _os
    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    out = subprocess.run(
        [_sys.executable, _os.path.join(repo, "tools", "soak_sanitize.py"),
         "1", "2"], capture_output=True, timeout=500, cwd=repo)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    assert b"no traps fired" in out.stdout


def test_plot_edit_metric_m_only():
    p = plot_alignment("ACGTACGTAC", "ACGTTCGTAC", distance="levenshtein")
    assert len(p.steps) > 0
    assert all(not v for v in p.comp_steps.values())
    assert (p.to_grid("M") >= 0).any()


def test_profiler():
    t = Timer()
    with t:
        pass
    assert t.counter.n == 1
    c = Counter()
    for x in (1.0, 2.0, 3.0):
        c.add(x)
    assert c.mean == 2.0 and c.min == 1.0 and c.max == 3.0


def test_check_alignment_rejects_bad():
    check_alignment("MMXM", "ACGT", "ACTT")
    with pytest.raises(AssertionError):
        check_alignment("MMMM", "ACGT", "ACTT")  # M over mismatch
    with pytest.raises(AssertionError):
        check_alignment("MMXM", "ACGT", "ACTT", end_v=3)


def test_verbose_and_check_api(capsys):
    a = WavefrontAligner("ACGTACGTAAACGT", backend="numpy", verbose=1,
                         check_alignment=True)
    a.wavefront_align("ACGTACGTAATCGT")
    err = capsys.readouterr().err
    assert "score=-4" in err and "status=0" in err


def test_print_wavefronts_display():
    """Wavefront-contents debug dump (reference: wavefront_display.c)."""
    import io
    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu.oracle import OracleAligner
    from pywfa_tpu.utils.display import print_wavefronts
    attr = WavefrontAligner(backend="numpy")._attributes()
    orc = OracleAligner(attr, keep_wavefronts=True)
    r = orc.align(b"TCTTTACTCGCGCGTT", b"TCTATACTGCGCGTT")
    buf = io.StringIO()
    print_wavefronts(orc.last_run, 0, r.wf_score, file=buf)
    out = buf.getvalue()
    assert ">[SCORE 0-" in out
    assert " M " in out and " I1 " in out and " D1 " in out
    assert "[ 3]" in out  # WF0 extended seed on k=0


def test_verbose3_progress_lines(monkeypatch, capsys):
    """verbose>=3 emits in-flight probe lines during segmented execution
    (reference: wavefront_unialign.c:277-324); probe_interval_global is a
    live config field."""
    import dataclasses
    import random
    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu.attributes import SystemParams
    from pywfa_tpu.batch import align_pairs
    from tests.corpus import set_mem_caps
    set_mem_caps(monkeypatch, 1, 1)
    rng = random.Random(5)
    pairs = [("".join(rng.choice("ACGT") for _ in range(200)),
              "".join(rng.choice("ACGT") for _ in range(190)))
             for _ in range(2)]
    attr = WavefrontAligner(backend="numpy")._attributes()
    attr = dataclasses.replace(attr, system=SystemParams(
        verbose=3, probe_interval_global=100))
    align_pairs(attr, [p.encode() for p, _ in pairs],
                [t.encode() for _, t in pairs])
    err = capsys.readouterr().err
    assert "[pywfa_tpu::align] Score" in err
    assert "% aligned" in err and "MemoryUsed" in err
