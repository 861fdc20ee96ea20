#!/usr/bin/env python
"""Smoke run of the aligner on one NVIDIA GPU, through its public entry
points, at the batch shapes its users run.

    python chip_smoke.py           # one card, phases 1-6 below
    python chip_smoke.py --four    # four cards: the sharded path only

Phases (one process; the first failure exits non-zero):

1. device stamp: platform, device kind and count, the card's name and
   power limit from nvidia-smi; fails unless the platform is `gpu` and
   the native host library (match-fill) is built;
2. compile: every engine program of phase 3, compiled ahead of time at
   its real batch shape, with its `memory_analysis()`;
3. oracle: each configuration of CASES through `batch.align_pairs`,
   compared byte for byte with the scalar oracle on (status, score,
   CIGAR); the mismatch count must be 0;
4. end to end: `align_pairs_stream` (depth 3), `align_pairs`,
   `BatchWavefrontAligner.align`, the README pair through
   `WavefrontAligner`, and one `pywfa_tpu.cli align` run on FASTA files
   generated from the seed;
5. the chip tests (`tests/test_gpu.py`, marker `gpu`), in this process;
6. the last line: {"ok": true, "device": {...}}.

Every phase prints its wall time with compile time apart, beside the
card's name and power limit. `--four` runs one 4 x 4096 x 150 bp
full-scope batch through `parallel.sharded_align_batch` plus the sharded
traceback walk, and compares it byte for byte with the same pairs on one
card; it runs no other phase.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
README_PAIR = ("TCTTTACTCGCGCGTTGGAGAAATACAATAGT",
               "TCTATACTGCGCGTTTGGAGAAATAAAATAGT")
README_RESULT = (-24, "3M1X4M1D7M1I9M1X6M")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Case:
    """One aligner configuration at one batch shape."""

    name: str
    n: int              # pairs per batch
    length: int         # pattern length; texts are mutated copies
    div: float          # per-base edit rate (60% subs, 40% indels)
    kw: tuple           # WavefrontAligner kwargs, as sorted items
    n_oracle: int       # pairs compared with the oracle
    # HeuristicParams fields, for strategies the pywfa API does not name
    hparams: Optional[tuple] = None
    segmented: bool = False  # force the segmented/remat traceback path


def _case(name, n, length, div, n_oracle, hparams=None, segmented=False,
          **kw):
    return Case(name, n, length, div, tuple(sorted(kw.items())), n_oracle,
                tuple(sorted(hparams.items())) if hparams else None,
                segmented)


EF = dict(span="ends-free", pattern_begin_free=10, pattern_end_free=10,
          text_begin_free=10, text_end_free=10)

# the batch shapes of the repo's workloads (BASELINE.json configs 1-5):
# short reads 150 bp x 4096, 1 kb x 512, 10 kb x 32, plus one long-read
# batch forced onto the segmented traceback path
CASES = (
    _case("150bp affine", 4096, 150, 0.03, 512, span="end-to-end"),
    _case("150bp ends-free", 4096, 150, 0.03, 512, **EF),
    _case("150bp affine2p", 4096, 150, 0.03, 512, distance="affine2p",
          span="end-to-end"),
    _case("150bp edit", 4096, 150, 0.03, 512, distance="levenshtein",
          span="end-to-end"),
    _case("150bp score-only", 4096, 150, 0.03, 512, scope="score",
          span="end-to-end"),
    _case("150bp wfmash", 4096, 150, 0.08, 512, span="end-to-end",
          hparams=dict(strategy="WFMASH", min_wavefront_length=10,
                       max_distance_threshold=30)),
    _case("1kb affine adaptive", 512, 1000, 0.05, 128, span="end-to-end",
          heuristic="adaptive"),
    _case("10kb adaptive", 32, 10000, 0.05, 8, span="end-to-end",
          heuristic="adaptive"),
    _case("4kb segmented", 16, 4000, 0.03, 16, segmented=True,
          span="end-to-end"),
)


def make_pairs(rng: np.random.Generator, n: int, length: int, div: float):
    """n (pattern, text) byte pairs: random ACGT patterns of `length`,
    texts with substitutions (60%) and 1-base insertions/deletions (40%)
    at per-base rate `div`."""
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pats = alpha[rng.integers(0, 4, (n, length))]
    out_p, out_t = [], []
    for i in range(n):
        p = pats[i]
        r = rng.random(length)
        sub = r < 0.6 * div
        dele = (r >= 0.6 * div) & (r < 0.8 * div)
        ins = (r >= 0.8 * div) & (r < div)
        t = p.copy()
        t[sub] = alpha[(np.searchsorted(alpha, t[sub])
                        + rng.integers(1, 4, int(sub.sum()))) % 4]
        reps = np.where(dele, 0, np.where(ins, 2, 1))
        t = np.repeat(t, reps)
        if ins.any():
            # the inserted copy of each insertion becomes a random base
            pos = np.cumsum(reps)[ins] - 1
            t[pos] = alpha[rng.integers(0, 4, len(pos))]
        out_p.append(p.tobytes())
        out_t.append(t.tobytes() or b"A")
    return out_p, out_t


def aligner_attributes(kw: dict, hparams: Optional[dict] = None):
    """(AlignerAttributes, wildcard byte or None) for WavefrontAligner
    kwargs `kw`, with HeuristicParams fields `hparams` (strategy by
    HeuristicStrategy name) for strategies the pywfa API does not name."""
    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu.attributes import HeuristicParams
    from pywfa_tpu.constants import HeuristicStrategy

    api = WavefrontAligner(backend="numpy", **kw)
    attr = api._attributes()
    if hparams is not None:
        h = dict(hparams, strategy=HeuristicStrategy[hparams["strategy"]])
        attr = dataclasses.replace(attr, heuristic=HeuristicParams(**h))
    return attr, (api._bwildcard if api._wildcard else None)


def attributes(case: Case):
    hp = dict(case.hparams) if case.hparams else None
    return aligner_attributes(dict(case.kw), hp)[0]


def oracle_mismatches(attr, pats, txts, results, n: int,
                      wildcard: Optional[int] = None) -> List[int]:
    """Indices among the first n pairs whose (status, score, ops) differ
    from the scalar oracle's."""
    from pywfa_tpu.oracle import OracleAligner
    orc = OracleAligner(attr, wildcard)
    bad = []
    for i in range(min(n, len(pats))):
        o = orc.align(pats[i], txts[i])
        r = results[i]
        if (r.status, r.score, r.ops) != (o.status, o.score, o.ops):
            bad.append(i)
    return bad


def forced_segmentation():
    """Device-memory budgets that send every full-CIGAR batch down the
    segmented/remat path (as tests/test_segmented.py forces it)."""
    from pywfa_tpu import batch
    return dataclasses.replace(batch.CPU_MEM_CAPS, choices=1,
                               replay_choices=2**20)


# ---------------------------------------------------------------------------
# Compile instrumentation
# ---------------------------------------------------------------------------

ENGINE_ENTRIES = ("align_batch_packed_full", "align_batch_packed_meta",
                  "align_batch_fused_full", "align_batch_fused_meta",
                  "align_batch_start", "align_batch_resume",
                  "align_batch_start_walk", "align_batch_replay_walk")


class _CompileOnly(Exception):
    pass


class Programs:
    """Wraps the engine's jitted entry points: the first call of each
    (entry, config, argument shapes) is lowered and compiled ahead of
    time -- timed, with its memory_analysis() printed -- and every call
    then runs on that executable. With `compile_only` set, a call stops
    after compiling (raises _CompileOnly)."""

    def __init__(self):
        self.exes = {}
        self.compile_s = 0.0
        self.compile_only = False
        self._saved = {}

    def __enter__(self):
        from pywfa_tpu.ops import engine as E
        for name in ENGINE_ENTRIES:
            fn = getattr(E, name)
            self._saved[name] = fn
            setattr(E, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        from pywfa_tpu.ops import engine as E
        for name, fn in self._saved.items():
            setattr(E, name, fn)

    def _wrap(self, name, fn):
        import jax
        from pywfa_tpu.ops import engine as E

        def call(cfg, *args):
            leaves, tree = jax.tree.flatten(args)
            key = (name, cfg, tree,
                   tuple((np.shape(x), str(getattr(x, "dtype", type(x))))
                         for x in leaves))
            exe = self.exes.get(key)
            if exe is None:
                t0 = time.perf_counter()
                exe = fn.lower(cfg, *args).compile()
                dt = time.perf_counter() - t0
                self.compile_s += dt
                self.exes[key] = exe
                B = leaves[0].shape[0] if leaves else 0
                mode = E._extend_mode(cfg, cfg.Lt + cfg.extend_chunk)
                print(f"  compiled {name} B={B} W={cfg.W} S_cap={cfg.S_cap} "
                      f"Lp={cfg.Lp} Lt={cfg.Lt} extend={mode} in {dt:.2f} s; "
                      f"{_memory(exe)}", flush=True)
            if self.compile_only:
                raise _CompileOnly()
            return exe(*args)
        return call


def _memory(exe) -> str:
    m = exe.memory_analysis()
    if m is None:
        return "memory_analysis: none"
    f = ("argument_size_in_bytes", "output_size_in_bytes",
         "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{k.replace('_size_in_bytes', '')}={getattr(m, k, 0) / 2**20:.1f} MiB"
        for k in f)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def stamp_device():
    """Phase 1. Returns (device, card line)."""
    import jax
    devs = jax.devices()
    d = devs[0]
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    check(d.platform == "gpu",
          f"JAX platform is {d.platform!r}, not 'gpu': no GPU found")
    # a child process that stays off JAX reads the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    from pywfa_tpu import native
    check(native.lib() is not None,
          "native library (pywfa_tpu/native) did not build: the host "
          "match-fill would fall back to NumPy")
    return d, card


class Phase:
    """Times a phase; prints wall time with compile time apart."""

    def __init__(self, name, programs, card):
        self.name, self.programs, self.card = name, programs, card

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        self.c0 = self.programs.compile_s if self.programs else 0.0
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            wall = time.perf_counter() - self.t0
            comp = (self.programs.compile_s - self.c0
                    if self.programs else 0.0)
            print(f"phase {self.name}: wall {wall:.3f} s, compile "
                  f"{comp:.3f} s, run {wall - comp:.3f} s [{self.card}]",
                  flush=True)


def _dispatch(case, attr, pats, txts):
    from pywfa_tpu import batch
    if case.segmented:
        caps = forced_segmentation()
        saved = batch.device_mem_caps
        batch.device_mem_caps = lambda: caps
        try:
            return batch.align_pairs(attr, pats, txts)
        finally:
            batch.device_mem_caps = saved
    return batch.align_pairs(attr, pats, txts)


def compile_cases(programs, cases, data):
    """Phase 2: compile the first engine program of every case."""
    programs.compile_only = True
    try:
        for case in cases:
            attr, pats, txts = data[case.name]
            print(f" {case.name}: {case.n} x {case.length} bp", flush=True)
            try:
                _dispatch(case, attr, pats, txts)
            except _CompileOnly:
                pass
            else:
                raise SmokeFailure(f"{case.name}: no engine program ran")
    finally:
        programs.compile_only = False


def oracle_cases(cases, data, oracle_calls):
    """Phase 3: every case through align_pairs vs the oracle."""
    total = 0
    for case in cases:
        attr, pats, txts = data[case.name]
        t0 = time.perf_counter()
        n0 = oracle_calls[0]
        res = _dispatch(case, attr, pats, txts)
        t_eng = time.perf_counter() - t0
        fallbacks = oracle_calls[0] - n0
        bad = oracle_mismatches(attr, pats, txts, res, case.n_oracle)
        total += len(bad)
        print(f" {case.name}: {len(res)} pairs in {t_eng:.3f} s, "
              f"{min(case.n_oracle, len(res))} compared with the oracle, "
              f"mismatches {len(bad)}, oracle fallbacks {fallbacks}",
              flush=True)
        check(len(res) == case.n, f"{case.name}: {len(res)} results")
        check(not bad, f"{case.name}: oracle mismatch at pairs {bad[:8]}")
        check(fallbacks * 10 <= case.n,
              f"{case.name}: {fallbacks} of {case.n} pairs fell back to "
              "the host oracle")
    print(f" oracle mismatches, all cases: {total}", flush=True)


def end_to_end(rng, case, work_dir, n_batches=4):
    """Phase 4: the user entry points on the 150 bp affine shape."""
    from pywfa_tpu import batch
    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu.cigar import ops_to_cigarstring
    from pywfa_tpu.cli import main as cli_main

    attr = attributes(case)
    batches = [make_pairs(rng, case.n, case.length, case.div)
               for _ in range(n_batches)]
    t0 = time.perf_counter()
    outs = list(batch.align_pairs_stream(attr, iter(batches), depth=3))
    dt = time.perf_counter() - t0
    print(f" align_pairs_stream depth 3: {n_batches} x {case.n} pairs in "
          f"{dt:.3f} s ({n_batches * case.n / dt:.0f} alignments/s)",
          flush=True)
    for (p, t), res in zip(batches, outs):
        bad = oracle_mismatches(attr, p, t, res, 64)
        check(len(res) == case.n and not bad,
              f"align_pairs_stream: oracle mismatch at {bad[:8]}")

    p, t = batches[0]
    t0 = time.perf_counter()
    res = batch.align_pairs(attr, p, t)
    dt = time.perf_counter() - t0
    print(f" align_pairs: {case.n} pairs in {dt:.3f} s "
          f"({case.n / dt:.0f} alignments/s)", flush=True)
    check([(r.status, r.score, r.ops) for r in res]
          == [(r.status, r.score, r.ops) for r in outs[0]],
          "align_pairs differs from align_pairs_stream on the same batch")

    ba = batch.BatchWavefrontAligner(**dict(case.kw))
    t0 = time.perf_counter()
    res_b = ba.align([s.decode() for s in p], [s.decode() for s in t])
    dt = time.perf_counter() - t0
    print(f" BatchWavefrontAligner.align: {case.n} pairs in {dt:.3f} s",
          flush=True)
    check([(r.status, r.score, r.ops) for r in res_b]
          == [(r.status, r.score, r.ops) for r in res],
          "BatchWavefrontAligner.align differs from align_pairs")

    a = WavefrontAligner(README_PAIR[0])
    t0 = time.perf_counter()
    r = a(README_PAIR[1])
    dt = time.perf_counter() - t0
    print(f" WavefrontAligner README pair: score {r.score} "
          f"{a.cigarstring} in {dt * 1e3:.3f} ms", flush=True)
    check((r.score, a.cigarstring) == README_RESULT,
          f"README pair: got {(r.score, a.cigarstring)}")
    t0 = time.perf_counter()
    a(README_PAIR[1])
    print(f" WavefrontAligner README pair, second call: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)

    os.makedirs(work_dir, exist_ok=True)
    n_cli = 512
    cp, ct = make_pairs(rng, n_cli, case.length, case.div)
    fp = os.path.join(work_dir, "patterns.fa")
    ft = os.path.join(work_dir, "texts.fa")
    fo = os.path.join(work_dir, "out.tsv")
    for path, seqs, tag in ((fp, cp, "p"), (ft, ct, "t")):
        with open(path, "w") as fh:
            for i, s in enumerate(seqs):
                fh.write(f">{tag}{i}\n{s.decode()}\n")
    t0 = time.perf_counter()
    rc = cli_main(["align", "--patterns", fp, "--texts", ft, "--out", fo,
                   "--span", "end-to-end"])
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli align exited {rc}")
    with open(fo) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh if ln.strip()]
    check(len(rows) == n_cli, f"cli wrote {len(rows)} rows, not {n_cli}")
    from pywfa_tpu.oracle import OracleAligner
    orc = OracleAligner(aligner_attributes(dict(span="end-to-end"))[0])
    by_name = {row[0]: row for row in rows}
    for i in range(64):
        o = orc.align(cp[i], ct[i])
        row = by_name[f"t{i}"]
        check((int(row[2]), int(row[3]), row[4])
              == (o.status, o.score, ops_to_cigarstring(o.ops)),
              f"cli row t{i} differs from the oracle")
    print(f" cli align: {n_cli} pairs in {dt:.3f} s, 64 rows match the "
          "oracle", flush=True)


def run_chip_tests() -> None:
    """Phase 5: tests/test_gpu.py in this process (the card is held)."""
    import pytest
    os.environ["JAX_PLATFORMS"] = ""  # conftest: keep the GPU
    rc = pytest.main([os.path.join(ROOT, "tests", "test_gpu.py"), "-m",
                      "gpu", "-q", "-s", "-p", "no:cacheprovider", "-x",
                      "-o", "addopts="])
    check(rc == 0, f"chip tests failed (pytest exit {rc})")


def four_cards(n_dev=4, per_dev=4096, length=150, div=0.03):
    """--four: one full-scope batch sharded over n_dev cards (score loop
    and traceback walk), byte-compared with the same pairs on one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pywfa_tpu.batch import (PATTERN_SENTINEL, TEXT_SENTINEL,
                                 encode_batch)
    from pywfa_tpu.ops import engine as E
    from pywfa_tpu.parallel import make_mesh, sharded_align_batch
    from pywfa_tpu.parallel.mesh import DATA_AXIS

    devs = jax.devices()
    check(len(devs) >= n_dev, f"need {n_dev} devices, have {len(devs)}")
    B = n_dev * per_dev
    rng = np.random.default_rng(SEED)
    pats, txts = make_pairs(rng, B, length, div)
    attr = aligner_attributes(dict(span="end-to-end"))[0]
    L = max(map(len, pats + txts))
    cfg = E.full_config(attr, L, L, W=128, S_cap=128)
    C = cfg.extend_chunk
    args_np = (encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL),
               encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL),
               np.fromiter(map(len, pats), np.int32, B),
               np.fromiter(map(len, txts), np.int32, B),
               np.zeros((B, 4), np.int32))
    ms = jnp.int32(2**31 - 1)

    def walk(out):
        ok = out["status"] == E.ST_END_REACHED
        w = E.traceback_walk(cfg, out["choices"], out["final_s"],
                             out["end_k"], ok)
        res = {k: np.asarray(out[k]) for k in
               ("status", "final_s", "end_k", "end_off")}
        res.update(zip(("ops_fwd", "n_ops", "k_start", "fb"),
                       map(np.asarray, w)))
        return res

    def timed(label, fn):
        t0 = time.perf_counter()
        res = fn()
        t1 = time.perf_counter()
        res2 = fn()
        t2 = time.perf_counter()
        print(f" {label}: first call {t1 - t0:.3f} s (compile incl.), "
              f"second {t2 - t1:.3f} s", flush=True)
        for k in res:
            check(np.array_equal(res[k], res2[k]), f"{label}: {k} unstable")
        return res

    one = jax.device_put(args_np, devs[0])
    ref = timed("one card", lambda: walk(E.align_batch(cfg, *one, ms)))
    mesh = make_mesh(devs[:n_dev])
    b1 = NamedSharding(mesh, P(DATA_AXIS))
    b2 = NamedSharding(mesh, P(DATA_AXIS, None))
    sh = [jax.device_put(a, s) for a, s in
          zip(args_np, (b2, b2, b1, b1, b2))]
    fn = sharded_align_batch(cfg, mesh)
    got = timed(f"{n_dev} cards, batch-sharded",
                lambda: walk(fn(*sh, ms)))
    done = int((ref["status"] == E.ST_END_REACHED).sum())
    check(done * 100 >= B * 99, f"only {done}/{B} pairs completed")
    for k in ref:
        check(np.array_equal(ref[k], got[k]),
              f"sharded {k} differs from the one-card run")
    print(f" {n_dev}-card sharded run byte-equal to one card on "
          f"{', '.join(ref)} ({B} pairs, {done} completed)", flush=True)
    return n_dev


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    try:
        import jax
        import pywfa_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the aligner: {e}", file=sys.stderr)
        return 1
    try:
        dev, card = stamp_device()
        if four:
            with Phase("four cards", None, card):
                four_cards()
        else:
            rng = np.random.default_rng(SEED)
            data = {}
            for case in CASES:
                p, t = make_pairs(rng, case.n, case.length, case.div)
                data[case.name] = (attributes(case), p, t)
            from pywfa_tpu import batch
            oracle_calls = [0]
            real_oracle = batch._oracle_one

            def counted(*a, **k):
                oracle_calls[0] += 1
                return real_oracle(*a, **k)

            batch._oracle_one = counted
            with Programs() as programs:
                with Phase("2 compile", programs, card):
                    compile_cases(programs, CASES, data)
                with Phase("3 oracle", programs, card):
                    oracle_cases(CASES, data, oracle_calls)
                with Phase("4 end to end", programs, card):
                    end_to_end(rng, CASES[0],
                               os.path.join(ROOT, ".smoke"))
                with Phase("5 chip tests", programs, card):
                    run_chip_tests()
                print(f"compile total: {programs.compile_s:.3f} s over "
                      f"{len(programs.exes)} programs [{card}]", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
