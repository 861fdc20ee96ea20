"""Adversarial benchmark sweep -> BENCH_SWEEP_r{N}.json.

Grid: divergence {2%, 5%, 10%} x length {150, 1k, 10k} x scope
{full, score}, measured END-TO-END through align_pairs (host encode +
device pipeline + host CIGAR assembly + escalation-ladder re-runs all
included), plus heuristic-on long-read rows (10kb x wfadaptive/X-drop,
the realistic operating point) and the pipelined align_pairs_stream
number for the headline shape. Unlike bench.py (which isolates the device pipeline), these
numbers charge every host-side and escalation cost to the config that
incurs it -- the escalation ladder's real price at high divergence is
the point of the artifact.

Usage: python tools/bench_sweep.py [out.json]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_pairs(rng, n, length, sub, ind):
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats, txts = [], []
    for _ in range(n):
        p = alpha[rng.integers(0, 4, length)]
        keep = rng.random(length) >= ind / 2
        t = p[keep].copy()
        subs = rng.random(len(t)) < sub
        t[subs] = alpha[rng.integers(0, 4, subs.sum())]
        ins = rng.random(len(t)) < ind / 2
        # insertions: duplicate marked positions
        t = np.repeat(t, 1 + ins.astype(np.int64))
        pats.append(p.tobytes())
        txts.append(t.tobytes())
    return pats, txts


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "BENCH_SWEEP_r05.json"
    import jax
    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu.batch import align_pairs, align_pairs_stream

    BASELINE = 10e6  # cells/s north star
    sizes = {150: 4096, 1000: 512, 10000: 32}
    iters_for = {150: 3, 1000: 2, 10000: 1}
    records = []
    device = str(jax.devices()[0])
    print(f"device={device}", file=sys.stderr)

    for L, B in sizes.items():
        for div in (0.02, 0.05, 0.10):
            rng = np.random.default_rng(int(L + div * 1000))
            pats, txts = make_pairs(rng, B, L, sub=div * 2 / 3, ind=div / 3)
            for scope in ("full", "score"):
                attr = WavefrontAligner(backend="numpy", span="end-to-end",
                                        scope=scope)._attributes()

                def run():
                    return align_pairs(attr, pats, txts)
                res = run()  # warm/compile
                n_ok = sum(1 for r in res if r.status == 0)
                iters = iters_for[L]
                t0 = time.time()
                for _ in range(iters):
                    run()
                dt = (time.time() - t0) / iters
                cells = B * L * L
                rec = dict(length=L, batch=B, divergence=div, scope=scope,
                           wall_s_per_batch=round(dt, 4),
                           pairs_per_s=round(B / dt, 1),
                           cells_per_s=round(cells / dt, 1),
                           vs_baseline=round(cells / dt / BASELINE, 1),
                           complete=n_ok, total=B)
                records.append(rec)
                print(f"L={L:<6d} div={div:<5} scope={scope:<6}"
                      f" {dt*1e3:9.1f} ms  {cells/dt/1e9:8.2f} GCUPS "
                      f" ({n_ok}/{B} ok)", file=sys.stderr, flush=True)

    # heuristic-on long reads: the realistic 10kb operating point
    # (BASELINE configs 4/5 pair heuristics with 1kb+ reads; exact
    # alignment at 10% divergence is the adversarial corner, not the
    # production path)
    for heur in ("adaptive", "X-drop"):
        for div in (0.05, 0.10):
            L, B = 10000, 32
            rng = np.random.default_rng(int(L + div * 1000))
            pats, txts = make_pairs(rng, B, L, sub=div * 2 / 3, ind=div / 3)
            attr = WavefrontAligner(backend="numpy", span="end-to-end",
                                    heuristic=heur)._attributes()
            res = align_pairs(attr, pats, txts)  # warm
            t0 = time.time()
            res = align_pairs(attr, pats, txts)
            dt = time.time() - t0
            n_ok = sum(1 for r in res if r.status == 0)
            cells = B * L * L
            rec = dict(length=L, batch=B, divergence=div, scope="full",
                       heuristic=heur, wall_s_per_batch=round(dt, 4),
                       pairs_per_s=round(B / dt, 1),
                       cells_per_s=round(cells / dt, 1),
                       vs_baseline=round(cells / dt / BASELINE, 1),
                       complete=n_ok, total=B)
            records.append(rec)
            print(f"L={L:<6d} div={div:<5} heur={heur:<8}"
                  f" {dt*1e3:9.1f} ms  {cells/dt/1e9:8.2f} GCUPS "
                  f" ({n_ok}/{B} ok)", file=sys.stderr, flush=True)

    # ends-free rows: pywfa's DEFAULT span is ends-free (align.pyx:390-399)
    # and the glocal mapping shape (free text ends) is a different hot path
    # than end2end (wavefront_termination.c:115-162)
    for L, B in ((150, 4096), (1000, 512)):
        for div in (0.02, 0.05):
            rng = np.random.default_rng(int(L * 7 + div * 1000))
            pats, txts = make_pairs(rng, B, L, sub=div * 2 / 3, ind=div / 3)
            free = max(8, L // 10)
            attr = WavefrontAligner(backend="numpy", span="ends-free",
                                    text_begin_free=free,
                                    text_end_free=free)._attributes()
            res = align_pairs(attr, pats, txts)  # warm
            n_ok = sum(1 for r in res if r.status == 0)
            iters = iters_for[L]
            t0 = time.time()
            for _ in range(iters):
                align_pairs(attr, pats, txts)
            dt = (time.time() - t0) / iters
            cells = B * L * L
            records.append(dict(
                length=L, batch=B, divergence=div, scope="full",
                span="ends-free", text_free=free,
                wall_s_per_batch=round(dt, 4),
                pairs_per_s=round(B / dt, 1),
                cells_per_s=round(cells / dt, 1),
                vs_baseline=round(cells / dt / BASELINE, 1),
                complete=n_ok, total=B))
            print(f"L={L:<6d} div={div:<5} ends-free(tf={free})"
                  f" {dt*1e3:9.1f} ms  {cells/dt/1e9:8.2f} GCUPS "
                  f" ({n_ok}/{B} ok)", file=sys.stderr, flush=True)

    # pipelined stream at the headline shape, all divergences + the
    # ends-free production span; median of RUNS passes with per-run spread
    # (single runs vary; the median is reported)
    RUNS = int(os.environ.get("SWEEP_STREAM_RUNS", 5))
    stream_rows = [("end-to-end", 0, 0.02), ("end-to-end", 0, 0.05),
                   ("end-to-end", 0, 0.10), ("ends-free", 15, 0.02),
                   ("ends-free", 15, 0.05)]
    for span, free, div in stream_rows:
        B, L, NB = 4096, 150, 10
        kw = {} if span == "end-to-end" else dict(text_begin_free=free,
                                                  text_end_free=free)
        attr = WavefrontAligner(backend="numpy", span=span,
                                **kw)._attributes()
        batches = [make_pairs(np.random.default_rng(s + int(div * 100)),
                              B, L, sub=div * 2 / 3, ind=div / 3)
                   for s in range(NB)]

        def streamed():
            n = 0
            for rs in align_pairs_stream(attr, iter(batches), depth=4):
                n += len(rs)
            return n
        streamed()  # warm
        runs = []
        for _ in range(RUNS):
            t0 = time.time()
            n = streamed()
            runs.append((time.time() - t0) / NB)
        assert n == NB * B
        dt = float(np.median(runs))
        cells = B * L * L
        rec = dict(length=L, batch=B, divergence=div, scope="full",
                   span=span, mode="stream",
                   wall_s_per_batch=round(dt, 4),
                   run_ms=[round(r * 1e3, 1) for r in runs],
                   pairs_per_s=round(B / dt, 1),
                   cells_per_s=round(cells / dt, 1),
                   vs_baseline=round(cells / dt / BASELINE, 1))
        if span == "ends-free":
            rec["text_free"] = free
        records.append(rec)
        print(f"stream L=150 {span} div={div:<5} {dt*1e3:9.1f} ms "
              f"(runs {[round(r*1e3,1) for r in runs]}) "
              f"{cells/dt/1e9:8.2f} GCUPS", file=sys.stderr, flush=True)

    out = dict(device=device, note=(
        "end-to-end wall time through align_pairs/align_pairs_stream: host "
        "encode + device pipeline + host CIGAR assembly + escalation "
        "ladder re-runs all included (bench.py isolates the device "
        "pipeline instead)"), records=records)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
