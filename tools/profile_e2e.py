#!/usr/bin/env python
"""End-to-end pipeline decomposition -> PROFILE_r{N}.json.

Measures, at the headline shape (B=4096, 150 bp, 2% divergence):

- the blocking align_pairs path with PYWFA_PROF per-stage wall times;
- the pipelined align_pairs_stream path: N runs, per-yield wall times,
  per-stage accumulation, median-of-runs throughput;
- the per-batch byte budget (push/pull sizes) from the engine config.

Every stage of the stream-vs-device-pipeline gap is a recorded number.

Usage: python tools/profile_e2e.py [out.json]
"""
import json
import os
import sys
import time

os.environ["PYWFA_PROF"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

B = int(os.environ.get("BENCH_B", 4096))
L = int(os.environ.get("BENCH_L", 150))
DIV = float(os.environ.get("BENCH_DIV", 0.02))
NB = int(os.environ.get("BENCH_NB", 16))
RUNS = int(os.environ.get("BENCH_RUNS", 5))
DEPTH = int(os.environ.get("BENCH_DEPTH", 4))
WORKERS = int(os.environ.get("BENCH_WORKERS", 1))


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "PROFILE_r05.json"
    import jax
    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu import batch as BT
    from pywfa_tpu.ops import engine as E
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench_sweep import make_pairs

    device = str(jax.devices()[0])
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    batches = [make_pairs(np.random.default_rng(s + 1), B, L,
                          sub=DIV * 2 / 3, ind=DIV / 3) for s in range(NB)]
    print(f"device={device} B={B} L={L} div={DIV} NB={NB} runs={RUNS}",
          file=sys.stderr)

    # per-batch wire budget from the ACTUAL production config: dispatch
    # one small batch of the same shape and read the rung config off the
    # in-flight handle (no duplicated rung-derivation formulas -- if
    # dispatch's rung math changes, this artifact follows automatically;
    # the rung is independent of batch size)
    h_probe = BT.align_pairs_dispatch(attr, batches[0][0][:16],
                                      batches[0][1][:16])
    cfg = h_probe.cfg
    BT.align_pairs_finish(h_probe)
    pp, pt = E.packed_widths(cfg)
    push_bytes = B * (pp + pt)  # fused 2-bit rows
    assert E.packed_layout(cfg) == "compact"
    pull_bytes = B * (14 + cfg.ops_out // 2)
    wire = dict(push_bytes_per_batch=push_bytes,
                pull_bytes_per_batch=pull_bytes)
    print(f"wire: {wire}", file=sys.stderr)

    def snap_prof():
        stages = {k: round(BT.PROF[k] * 1e3, 2) for k in sorted(BT.PROF)}
        calls = {k: BT.PROF_N[k] for k in sorted(BT.PROF_N)}
        BT.prof_report()  # reset
        return stages, calls

    # blocking path
    BT.align_pairs(attr, *batches[0])  # warm/compile
    snap_prof()
    t0 = time.perf_counter()
    for i in range(4):
        BT.align_pairs(attr, *batches[i % NB])
    dt_block = (time.perf_counter() - t0) / 4
    stages, _ = snap_prof()
    blocking = dict(ms_per_batch=round(dt_block * 1e3, 1),
                    pairs_per_s=round(B / dt_block, 1),
                    stages_ms_total_4=stages)
    print(f"blocking: {blocking['ms_per_batch']} ms/batch", file=sys.stderr)

    # streamed path: RUNS passes, per-yield walls + per-stage totals
    list(BT.align_pairs_stream(attr, iter(batches[:2]), depth=DEPTH,
                               workers=WORKERS))  # warm
    snap_prof()
    runs = []
    for r in range(RUNS):
        marks = []
        t0 = time.perf_counter()
        n = 0
        for rs in BT.align_pairs_stream(attr, iter(batches), depth=DEPTH,
                                        workers=WORKERS):
            n += len(rs)
            marks.append(time.perf_counter() - t0)
        assert n == NB * B
        stages, calls = snap_prof()
        per_yield = [round((marks[i] - (marks[i - 1] if i else 0)) * 1e3, 1)
                     for i in range(len(marks))]
        runs.append(dict(
            ms_per_batch=round(marks[-1] / NB * 1e3, 2),
            per_yield_ms=per_yield,
            stages_ms_per_batch={k: round(v / NB, 2)
                                 for k, v in stages.items()}))
        print(f"stream run {r}: {runs[-1]['ms_per_batch']} ms/batch "
              f"stages/batch={runs[-1]['stages_ms_per_batch']}",
              file=sys.stderr, flush=True)
    med = float(np.median([r["ms_per_batch"] for r in runs]))
    stream = dict(depth=DEPTH, workers=WORKERS, n_batches=NB, runs=runs,
                  median_ms_per_batch=round(med, 2),
                  pairs_per_s=round(B / (med / 1e3), 1))

    out = dict(
        device=device,
        config=dict(B=B, L=L, divergence=DIV),
        note=(
            "Per-stage decomposition of the end-to-end pipeline at the "
            "headline shape. Stage keys: d.config (attr validation + "
            "config memo), d.encode (host tokenize + 2-bit pack), "
            "d.push_enqueue (device transfer enqueue), f.pull (wait for "
            "+ materialize the packed result; ~0 when the pipeline is "
            "deep enough that the async copy finished), f.native_fill "
            "(C++ batched match-fill + string assembly), f.assemble "
            "(result construction), f.escalate/f.oracle (tail re-runs). "
            "wire holds the per-batch push/pull byte counts. The stream "
            "pipelines the transfers and device time behind host "
            "stages."),
        wire=wire,
        blocking=blocking,
        stream=stream,
    )
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {out_path}: stream median {med:.1f} ms/batch = "
          f"{B / (med / 1e3):,.0f} pairs/s", file=sys.stderr)


if __name__ == "__main__":
    main()
