#!/usr/bin/env python
"""pywfa_tpu quick tour: single-pair API, batch API, plotting, packed input.

Run: python examples/demo.py   (CPU or GPU; first call compiles)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pywfa_tpu import WavefrontAligner, clip_cigartuples

# --- pywfa-compatible single-pair API -----------------------------------
pattern = "TCTTTACTCGCGCGTTGGAGAAATACAATAGT"
text = "TCTATACTGCGCGTTTGGAGAAATAAAATAGT"
a = WavefrontAligner(pattern)
res = a(text)
print("score:", res.score)              # -24
print("cigar:", a.cigarstring)          # 3M1X4M1D7M1I9M1X6M
print(res.pretty)

# --- dual-affine, ends-free, clipping ------------------------------------
a2 = WavefrontAligner(distance="affine2p", span="ends-free")
res2 = a2("GGCCAAAAACCAAAAAA", "AAAAACCTTTTTAAAAAA", clip_cigar=True,
          min_aligned_bases_left=5, min_aligned_bases_right=5)
print("clipped:", res2.cigartuples)

# --- batched API ----------------------------------------------------------
from pywfa_tpu.batch import BatchWavefrontAligner

rng = np.random.default_rng(0)
alpha = np.frombuffer(b"ACGT", np.uint8)
pats = ["".join(map(chr, alpha[rng.integers(0, 4, 150)])) for _ in range(64)]
txts = [p[:70] + p[71:] for p in pats]  # one deletion each
ba = BatchWavefrontAligner(span="end-to-end")
results = ba.align(pats, txts)
print("batch scores:", sorted({r.score for r in results}))
print("example sam cigar:", results[0].sam_cigar)

# --- pipelined streaming (production throughput path) ----------------------
# several batches stay in flight: device compute, transfers, and host CIGAR
# assembly all overlap (this is what the CLI uses)
stream_in = [(pats[i::4], txts[i::4]) for i in range(4)]
n = sum(len(rs) for rs in ba.align_stream(iter(stream_in)))
print("streamed", n, "alignments over", len(stream_in), "batches")

# --- wavefront heatmap (debug tooling) ------------------------------------
from pywfa_tpu.utils.plot import plot_alignment

plot = plot_alignment(pattern, text, span="end-to-end")
print("wavefront heatmap:")
print(plot.to_text())

# --- IUPAC / custom match-equivalence classes -----------------------------
# (the tensor form of WFA2-lib's lambda match mode)
ai = WavefrontAligner(pattern="ANGTRCGT", match_classes="iupac",
                      span="end-to-end")
print("iupac score:", ai("ACGTACGT").score)  # 0: N matches all, R matches A/G

# --- resume after max_steps ----------------------------------------------
ar = WavefrontAligner(pattern=pats[0], span="end-to-end", max_steps=4)
ar.wavefront_align(txts[0])
print("paused status:", ar.status)           # -100 (MAX_STEPS_REACHED)
ar.max_steps = 10_000
print("resumed score:", ar.wavefront_align_resume())

# --- per-component heatmaps + behavior map --------------------------------
p2 = plot_alignment(pattern, text, span="end-to-end", distance="affine2p")
print("I1 band cells:", int((p2.to_grid("I1") >= 0).sum()),
      "| extend-reached cells:", int((p2.behavior_grid() == 2).sum()))
