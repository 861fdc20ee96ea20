"""Host-side batched alignment pipeline.

Feeds the JAX engine (pywfa_tpu.ops.engine) with encoded, padded sequence
batches; reconstructs CIGARs from the traceback walk by greedy match-fill
(the dense-tensor analog of WFA2-lib's pcigar unpack,
wavefront_backtrace_buffer.c); and escalates/falls back for rare cases
(band/score bucket overflow, dropped or heuristic-partial alignments) so
results are always complete and byte-faithful.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .attributes import AlignerAttributes, classic_score, validate_alignment
from .cigar import Cigar, cigar_maxtrim
from .constants import (
    AlignmentScope,
    AlignmentSpan,
    HeuristicStrategy,
    MemoryMode,
    OFFSET_NULL,
    STATUS_ALG_COMPLETED,
    STATUS_ALG_PARTIAL,
    STATUS_MAX_STEPS_REACHED,
)
from .oracle import OracleAligner, OracleResult
from .ops import engine as E

PATTERN_SENTINEL = E.PATTERN_PAD
TEXT_SENTINEL = E.TEXT_PAD


@dataclasses.dataclass(frozen=True)
class MemCaps:
    """Device-memory budgets (bytes) that decide how a batch executes.

    lcp_table: the per-diagonal LCP table of a one-shot dispatch
        (3 * B * W * Ltp bytes incl. build scratch); above it the engine
        extends by chunked sequence compares instead.
    choices: the traceback choices tensor (S_cap * B * W bytes); above it
        full-CIGAR batches run segmented with rematerialized traceback.
    replay_choices: ONE rematerialized segment's choices block
        (K * B * W); sets the segment length K of the segmented path.
    lcp_table_remat: the LCP table of a segmented run, whose bounded
        choices block leaves room for a bigger table.
    """

    lcp_table: int
    choices: int
    replay_choices: int
    lcp_table_remat: int


# fixed budgets on the CPU backend (tests, small runs)
CPU_MEM_CAPS = MemCaps(lcp_table=3 * 2**30, choices=4 * 2**30,
                       replay_choices=512 * 2**20, lcp_table_remat=8 * 2**30)

# on the GPU each budget is this share of the device's memory limit: the
# CPU budgets above as fractions of a 16 GiB device
_GPU_MEM_SHARES = MemCaps(lcp_table=3 / 16, choices=1 / 4,
                          replay_choices=1 / 32, lcp_table_remat=1 / 2)


def mem_caps_for(platform: str, bytes_limit: Optional[int]) -> MemCaps:
    """Budgets for a device of `platform` with `bytes_limit` bytes of
    memory (`device.memory_stats()["bytes_limit"]`). A platform without
    a rule is an error, not a default."""
    if platform == "cpu":
        return CPU_MEM_CAPS
    if platform != "gpu":
        raise RuntimeError(f"no device-memory budget rule for platform "
                           f"{platform!r}")
    if not bytes_limit:
        raise RuntimeError("GPU device reports no memory_stats bytes_limit")
    return MemCaps(*(int(bytes_limit * f)
                     for f in dataclasses.astuple(_GPU_MEM_SHARES)))


@functools.lru_cache(maxsize=1)
def device_mem_caps() -> MemCaps:
    """MemCaps of the default device (read once per process)."""
    dev = jax.devices()[0]
    stats = dev.memory_stats() if dev.platform != "cpu" else None
    return mem_caps_for(dev.platform, (stats or {}).get("bytes_limit"))


# PYWFA_PROF=1 accumulates per-stage wall time of the dispatch/finish
# pipeline into PROF (print with prof_report()); near-zero cost when off
_PROF = os.environ.get("PYWFA_PROF", "") not in ("", "0")
PROF = collections.defaultdict(float)
PROF_N = collections.defaultdict(int)


def _prof_add(key: str, t0: float) -> float:
    t1 = time.perf_counter()
    PROF[key] += t1 - t0
    PROF_N[key] += 1
    return t1


def prof_report(reset: bool = True) -> str:
    lines = [f"{k:28s} {PROF[k]*1e3:9.2f} ms total "
             f"({PROF[k]/max(PROF_N[k],1)*1e3:7.3f} ms/call x {PROF_N[k]})"
             for k in sorted(PROF, key=PROF.get, reverse=True)]
    if reset:
        PROF.clear()
        PROF_N.clear()
    return "\n".join(lines)


def encode_batch(seqs: Sequence[bytes], L: int, chunk: int, sentinel: int,
                 lens: Optional[np.ndarray] = None) -> np.ndarray:
    """[B, L + chunk] int8 tokens, sentinel-padded past each sequence's end.

    Vectorized: one flat copy of the concatenated bytes plus a single fancy
    scatter (a Python loop over B pairs costs ~15 ms at B=4096).
    """
    B = len(seqs)
    out = np.full((B, L + chunk), sentinel, dtype=np.int8)
    if B == 0:
        return out
    if lens is None:
        lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=B)
    if (lens == lens[0]).all() and lens[0] == L:
        out[:, :L] = np.frombuffer(b"".join(seqs), dtype=np.uint8) \
            .reshape(B, L).view(np.int8)
        return out
    flat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    starts = np.cumsum(lens) - lens
    rows = np.repeat(np.arange(B), lens)
    cols = np.arange(flat.size) - np.repeat(starts, lens)
    out[rows, cols] = flat.view(np.int8)
    return out


def _match_fill(pattern: bytes, text: bytes, ops_fwd: np.ndarray, n_ops: int,
                k_start: int, plen: int, tlen: int,
                wildcard: Optional[int],
                cap_h: Optional[int] = None,
                mtbl: Optional[np.ndarray] = None) -> str:
    """Expand a (sparse, forward-order) walk-op stream into per-base ops.

    Match runs are re-derived by greedy forward extension, which is exact for
    WFA paths because stored offsets are maximally extended (the same
    argument that makes the reference's pcigar unpack exact,
    wavefront_pcigar.c unpack + wavefront_backtrace_buffer.c).

    cap_h: for dropped (z-drop) partial walks, the FINAL run is FORCED to
    `max(0, cap_h - h)` 'M' ops with no equality check: the reference
    backtraces from the recorded historic-max offset, which may be stale
    relative to the drop-score wavefront, and writes
    `num_matches = end_offset - predecessor` match ops even across real
    mismatches (reference: wavefront_backtrace.c:425-436 takes num_matches
    from the passed-in offset, not the sequences). Intermediate runs always
    reconnect stored (maximally extended) offsets, where greedy == exact.
    """
    pa = np.frombuffer(pattern, dtype=np.uint8)
    ta = np.frombuffer(text, dtype=np.uint8)
    if k_start >= 0:
        v, h = 0, int(k_start)
    else:
        v, h = -int(k_start), 0
    parts: List[str] = []
    # leading free indels (reference: wavefront_backtrace.c:514-516)
    if h > 0:
        parts.append("I" * h)
    if v > 0:
        parts.append("D" * v)

    def extend(final: bool) -> None:
        nonlocal v, h
        if final and cap_h is not None:
            run = max(0, cap_h - h)  # forced (see docstring)
            if run > 0:
                parts.append("M" * run)
                v += run
                h += run
            return
        n = min(plen - v, tlen - h)
        if n <= 0:
            return
        a = pa[v: v + n]
        b = ta[h: h + n]
        if mtbl is not None:
            eq = (mtbl[a] & mtbl[b]) != 0
        else:
            eq = a == b
            if wildcard is not None:
                eq = eq | (a == wildcard) | (b == wildcard)
        run = n if eq.all() else int(np.argmin(eq))
        if run > 0:
            parts.append("M" * run)
            v += run
            h += run

    toks = np.asarray(ops_fwd[ops_fwd != 0])
    last_i = len(toks) - 1
    extend(last_i < 0)  # start-cell extension
    for i, tok in enumerate(toks):
        tok = int(tok)
        op = tok & 3
        if op == E.WOP_X:
            parts.append("X")
            v += 1
            h += 1
        elif op == E.WOP_I:
            parts.append("I")
            h += 1
        else:
            parts.append("D")
            v += 1
        if tok & E.WOP_MFLAG:
            extend(i == last_i)
    return "".join(parts)


def _native_fill(cfg, clean_idx, pat_np, txt_np, plens, tlens, end_k,
                 end_off, ops_fwd, n_ops, k_start, wildcard,
                 capped: bool = False) -> dict:
    """Batched C++ match-fill for the clean pairs; {} if lib unavailable.

    pat_np/txt_np: the already-encoded [B, L+C] int8 token matrices (the
    sentinel padding past each sequence end is never read). capped=True
    forces each pair's final run to its recorded end offset (dropped-pair
    partial walks; see _match_fill's cap_h).
    """
    from . import native
    if native.lib() is None or cfg.match_classes:
        # class-mask matching falls back to the Python fill (the native
        # kernel compares raw bytes + wildcard only)
        return {}
    idx = np.asarray(clean_idx)
    if len(idx) == pat_np.shape[0]:
        # whole batch clean (the common case): use the arrays as-is, no
        # fancy-index copies (~15 ms at B=4096)
        def sel(a):
            return np.ascontiguousarray(a)
    else:
        def sel(a):
            return np.ascontiguousarray(a[idx])
    pat = sel(pat_np).view(np.uint8)
    txt = sel(txt_np).view(np.uint8)
    ev = (sel(end_off) - sel(end_k)).astype(np.int64)
    eh = sel(end_off).astype(np.int64)
    trail_i = (sel(tlens) - eh).astype(np.int64)
    trail_d = (sel(plens) - ev).astype(np.int64)
    # the op stream is zero-sparse over the full row; scan all entries
    scan_lens = np.full(len(idx), ops_fwd.shape[1], dtype=np.int64)
    res = native.match_fill_batch(
        sel(ops_fwd).view(np.uint8),
        scan_lens,
        sel(k_start).astype(np.int64),
        pat, sel(plens).astype(np.int64),
        txt, sel(tlens).astype(np.int64),
        trail_i, trail_d,
        int(wildcard) if wildcard is not None else -1,
        caps=(eh if capped else None))
    if res is None:
        return {}
    out, out_lens = res
    # rows are already ASCII (translated in C); ONE decode of the whole
    # matrix, then per-pair str slices (per-row numpy fancy-indexing or
    # per-row bytes.decode cost several ms at B=4096). latin-1: a 1:1
    # byte map -- identical to ascii on the valid slices, but tolerant of
    # the uninitialized tail bytes of skipped (lens<0) rows
    flat = out.tobytes().decode("latin-1")
    cap = out.shape[1]
    lens = out_lens.tolist()
    return {int(b): flat[i * cap: i * cap + lens[i]]
            for i, b in enumerate(idx) if lens[i] >= 0}


_STRICT_ACGT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _STRICT_ACGT[_b] = _i


def pack_tokens(mat: np.ndarray, lens: np.ndarray,
                width: Optional[int] = None) -> Optional[np.ndarray]:
    """Token matrix [B, W] int8 -> fused 2-bit rows [B, ceil(width/4)]
    uint8 covering the leading `width` columns (default: all of them).
    Pass width=cfg.Lp/Lt to skip the extend_chunk tail -- every length
    is <= width there, and engine._decode_packed regenerates the
    sentinel tail on device, so those bytes never need to cross the
    host->device link (engine.packed_widths).

    Returns None when any in-length byte is not uppercase ACGT (the packed
    push must round-trip byte-exactly through engine._decode_packed).
    """
    if width is None or width > mat.shape[1]:
        width = mat.shape[1]
    lens = np.asarray(lens)
    if lens.size and int(lens.max()) > width:
        # precondition violated (a sequence longer than the packed
        # region): fail the pack -> caller uses the raw-token push,
        # never a silently truncated sequence
        return None
    from . import native
    if native.lib() is not None:
        return native.pack2_batch(mat, lens, width)  # None <=> non-ACGT
    codes = _STRICT_ACGT[mat.view(np.uint8)[:, :width]]
    valid = np.arange(width)[None, :] < lens[:, None]
    codes = np.where(valid, codes, np.uint8(0))
    if codes.max() == 255:  # non-ACGT byte inside a sequence
        return None
    padw = (-width) % 4
    if padw:
        codes = np.pad(codes, ((0, 0), (0, padw)))
    c = codes.reshape(mat.shape[0], -1, 4)  # 2-bit codes: u8 ops suffice
    return (c[..., 0] | (c[..., 1] << 2)
            | (c[..., 2] << 4) | (c[..., 3] << 6))


def _mtbl_for(cfg) -> Optional[np.ndarray]:
    """Class-mask table for host match-fill, or None for exact/wildcard."""
    if not cfg.match_classes:
        return None
    from .attributes import match_class_table
    return match_class_table(cfg.match_classes)


def _encode_side(seqs, L, chunk, sentinel, lens):
    """Encode one side of a batch: sentinel-padded token matrix plus its
    2-bit packed rows (None when any in-length byte is not ACGT). Fused
    native pass when the lib is available (numpy scatter + separate pack
    cost ~8 ms/side at B=4096; the native pass is <1 ms)."""
    from . import native
    if native.lib() is not None:
        r = native.encode_pack_batch(b"".join(seqs), lens, L + chunk,
                                     sentinel, pack_width=L)
        if r is not None:
            return r
    mat = encode_batch(seqs, L, chunk, sentinel, lens=lens)
    return mat, pack_tokens(mat, np.asarray(lens), width=L)


def _run_engine(cfg, pat_np, txt_np, plen, tlen, frees, max_steps,
                scope_full=True, pp=None, pt=None):
    """Enqueue the engine on one batch.

    pat_np/txt_np are HOST token matrices; the push is one fused array,
    2-bit packed when the batch is pure uppercase ACGT (4x fewer bytes).
    pp/pt: the 2-bit-packed rows from _encode_side (None when a side is
    not pure ACGT).

    Returns the packed single-pull output array: the _pack_full uint8
    vector when scope_full, else the 4xB int32 meta block -- produced by
    ONE compiled call (score loop + traceback walk + packing in the same
    program).
    """
    if pp is not None and pt is not None:
        fused2 = np.concatenate([pp, pt], axis=1)
        fn = (E.align_batch_packed_full if scope_full
              else E.align_batch_packed_meta)
        return fn(cfg, fused2, plen, tlen, frees, max_steps)
    fused = np.concatenate([pat_np, txt_np], axis=1)
    fn = (E.align_batch_fused_full if scope_full
          else E.align_batch_fused_meta)
    return fn(cfg, fused, plen, tlen, frees, max_steps)
@dataclasses.dataclass(**({"slots": True} if sys.version_info >= (3, 10)
                           else {}))
class BatchResult:
    """Per-pair outcome of a batched alignment."""

    status: int
    score: int
    ops: str
    end_v: int
    end_h: int
    wf_score: int
    dropped: bool

    @property
    def cigartuples(self):
        from .cigar import ops_to_cigartuples
        return ops_to_cigartuples(self.ops)

    @property
    def cigarstring(self) -> str:
        from .cigar import ops_to_cigarstring
        return ops_to_cigarstring(self.ops)

    @property
    def sam_cigar(self) -> str:
        from .cigar import cigar_sprint_sam
        return cigar_sprint_sam(self.ops, show_mismatches=False)



def _oracle_one(attr: AlignerAttributes, pattern: bytes, text: bytes,
                wildcard) -> "BatchResult":
    """Exact oracle fallback for one pair, with batch-mode per-pair
    ends-free clamping applied."""
    f = attr.form
    if f.span == AlignmentSpan.ENDS_FREE:
        attr = dataclasses.replace(attr, form=dataclasses.replace(
            f,
            pattern_begin_free=min(f.pattern_begin_free, len(pattern)),
            pattern_end_free=min(f.pattern_end_free, len(pattern)),
            text_begin_free=min(f.text_begin_free, len(text)),
            text_end_free=min(f.text_end_free, len(text))))
    r = OracleAligner(attr, wildcard).align(pattern, text)
    return BatchResult(r.status, r.score, r.ops, r.end_v, r.end_h,
                       r.wf_score, r.dropped)


def _unreachable_result(pen, scope_full: bool, wf_s: int, end_k: int,
                        end_off: int, ops: str) -> "BatchResult":
    """Native result assembly for a dropped/unreachable pair.

    Mirrors the reference's terminate paths byte-exactly
    (wavefront_unialign.c:158-173 score scope, :211-235 full scope):
    z-dropped pairs carry the historic-max end position; heuristic
    dead-ends carry no end position (DIAGONAL_NULL/OFFSET_NULL mirror).
    `ops` is the already match-filled op string ('' when no walk ran);
    full scope applies cigar_maxtrim and always reports ALG_PARTIAL.
    """
    from .constants import DIAGONAL_NULL
    if end_off <= OFFSET_NULL // 2:  # no recorded end position
        end_k, end_off = DIAGONAL_NULL, OFFSET_NULL
    if not scope_full:
        ev = end_off - end_k
        eh = end_off
        sc = classic_score(pen, ev, eh, wf_s)
        return BatchResult(STATUS_ALG_PARTIAL, sc, "", ev, eh, wf_s, True)
    cig = Cigar(ops=ops)
    cigar_maxtrim(cig, pen)
    return BatchResult(STATUS_ALG_PARTIAL, cig.score, cig.ops, cig.end_v,
                       cig.end_h, wf_s, True)


def _maxtrim_result(pen, sc: int, ops: str, ev: int, eh: int, wf_s: int
                    ) -> "BatchResult":
    """Extension-mode post-processing of a COMPLETED alignment: trim to the
    max-scoring prefix; trimmed => ALG_PARTIAL, untouched => ALG_COMPLETED
    (reference: wavefront_unialign.c:211-227 extension column)."""
    cig = Cigar(ops=ops, score=sc, end_v=ev, end_h=eh)
    trimmed = cigar_maxtrim(cig, pen)
    status = STATUS_ALG_PARTIAL if trimmed else STATUS_ALG_COMPLETED
    return BatchResult(status, cig.score, cig.ops, cig.end_v, cig.end_h,
                       wf_s, False)


def _build_frees(attr0, B: int, plens: np.ndarray, tlens: np.ndarray
                 ) -> np.ndarray:
    """Per-pair ends-free slack matrix [B, 4] (pattern_begin, pattern_end,
    text_begin, text_end), clamped to each pair's lengths. Extension mode
    gets the reference's WF-extend preset per pair: begin 0, end = length
    (reference: wavefront_align.c:57-63)."""
    form = attr0.form
    if form.span != AlignmentSpan.ENDS_FREE:
        return np.zeros((B, 4), dtype=np.int32)
    if form.extension:
        frees_np = np.zeros((B, 4), dtype=np.int32)
        frees_np[:, 1] = plens
        frees_np[:, 3] = tlens
        return frees_np
    frees_np = np.tile(np.array([[form.pattern_begin_free,
                                  form.pattern_end_free,
                                  form.text_begin_free,
                                  form.text_end_free]], dtype=np.int32),
                       (B, 1))
    # per-pair clamp: frees may not exceed the sequence lengths
    frees_np[:, 0] = np.minimum(frees_np[:, 0], plens)
    frees_np[:, 1] = np.minimum(frees_np[:, 1], plens)
    frees_np[:, 2] = np.minimum(frees_np[:, 2], tlens)
    frees_np[:, 3] = np.minimum(frees_np[:, 3], tlens)
    return frees_np


def _print_progress(cfg, B, s_now, state, snaps_bytes):
    """One in-flight progress line (verbose >= 3 analog of the reference's
    probe printer, wavefront_unialign.c:277-324), emitted at segment
    boundaries of the long-running paths."""
    slot = s_now % cfg.scope
    off = np.asarray(state["offsets"][E.M, slot])
    status = np.asarray(state["status"])
    running = status == E.ST_RUNNING
    karr = np.arange(cfg.W, dtype=np.int64) + cfg.kmin
    valid = off > E.NULL_THRESHOLD
    v = np.where(valid, off - karr[None, :], -1)
    h = np.where(valid, off, -1)
    dist = np.maximum(v, h).max(axis=1)  # [B] furthest cell per pair
    lohi = np.asarray(state["hi"][E.M, slot]) - np.asarray(
        state["lo"][E.M, slot]) + 1
    dist_total = max(cfg.Lp, cfg.Lt)
    dmax = float(dist[running].max(initial=-1))
    # a null current level reports -1 like the reference probe
    pct = 100.0 * dmax / max(dist_total, 1) if dmax >= 0 else -1.0
    dev_mb = E.memory_estimate(cfg, B)["total"] / 2**20
    print(f"[pywfa_tpu::align] Score {s_now} "
          f"(~ {pct:2.3f}% aligned, {int(running.sum())}/{B} running). "
          f"MemoryUsed(device,host-snapshots)=({dev_mb:.0f} MB,"
          f"{snaps_bytes / 2**20:.0f} MB). "
          f"Wavefronts ~ {lohi.max(initial=0) / 1e6:2.3f} Moffsets",
          file=sys.stderr, flush=True)


def _align_pairs_remat(attr, attr0, patterns, texts, wildcard, big_cfg,
                       plens, tlens, full_probe, Lp, Lt,
                       resume_snaps=None, resume_state=None,
                       resume_cfg=None, capture=None):
    """Bounded-memory execution by segment rematerialization.

    The forward score loop runs in segments of K steps WITHOUT recording
    choices; only the ring state at each segment boundary (the explicit
    resume pytree) is pulled to host RAM. The traceback then re-runs the
    segments highest-to-lowest, regenerating each segment's choices block
    on device and walking it inside the same compiled call
    (engine.align_batch_replay_walk) -- the block never materializes off
    device. Memory: device = ring + ONE K x B x W block; host = one ring
    snapshot per segment (scope*n_comp*4 bytes per band cell, i.e.
    ~100x smaller than the choice levels it replaces). This is the tensor
    engine's answer to BiWFA's O(s) memory (wavefront_bialign.c:48-750):
    recomputation instead of meet-in-the-middle bisection, at the same
    2x compute cost, batched and without the recursion's tiny base cases.

    The band is NOT forced to worst case: pairs that outgrow big_cfg.W
    report ST_OVERFLOW_W and escalate through align_pairs' geometric
    ladder with a 4x wider band.

    resume_snaps/resume_state/resume_cfg: continuation of a
    MAX_STEPS-paused run (see align_pairs_resume) -- the forward loop
    restarts from the retained ring state instead of score 0, with the
    paused boundary snapshotted so the traceback covers the continuation
    levels. capture: when given a dict and pairs end at MAX_STEPS, the
    retained state is stored under capture["paused"] for later resume.
    """
    import jax.numpy as jnp

    B = len(patterns)
    scope_full = attr0.scope == AlignmentScope.COMPUTE_ALIGNMENT
    S_total = full_probe.S_cap
    if resume_cfg is not None:
        cfg = dataclasses.replace(resume_cfg, record_choices=False)
        K = cfg.S_cap
    else:
        # long-read runs afford a bigger LCP table than one-shot dispatch
        # (their choices block is bounded, freeing device memory), so
        # re-decide from the remat-specific cap (big_cfg may arrive with
        # the table disabled)
        caps = device_mem_caps()
        lcp_ok = (3 * B * big_cfg.W * (big_cfg.Lt + big_cfg.extend_chunk)
                  <= caps.lcp_table_remat)
        cfg = dataclasses.replace(big_cfg, record_choices=False,
                                  use_lcp_table=lcp_ok)
        # segment size from the replay-block byte budget
        K = max(64, int(caps.replay_choices // max(1, B * cfg.W)))
        K = min(K, S_total)
        cfg = dataclasses.replace(cfg, S_cap=K)
    cfg_rec = dataclasses.replace(cfg, record_choices=True)
    C = cfg.extend_chunk
    pat_np = encode_batch(patterns, cfg.Lp, C, PATTERN_SENTINEL)
    txt_np = encode_batch(texts, cfg.Lt, C, TEXT_SENTINEL)
    pat = jnp.asarray(pat_np)
    txt = jnp.asarray(txt_np)
    plen = jnp.asarray(plens)
    tlen = jnp.asarray(tlens)
    frees_np = _build_frees(attr0, B, plens, tlens)
    frees = jnp.asarray(frees_np)
    max_steps = jnp.int32(min(attr0.system.max_alignment_steps, 2**31 - 1))

    # --- forward pass: no choices, snapshot each boundary to host ---
    verbose = attr0.system.verbose
    probe = max(attr0.system.probe_interval_global, 1)
    next_probe = probe
    # host copies of the resume pytree at segment starts 1..n-1
    snaps = list(resume_snaps) if resume_snaps else []
    if resume_state is None:
        out, state = E.align_batch_start(cfg, pat, txt, plen, tlen, frees,
                                         max_steps)
    else:
        # continuation of a MAX_STEPS pause: un-pause the retained ring
        # and snapshot the boundary so the walk covers the new levels
        # (reference: wavefront_align.c:245-266)
        st = E.unpause_max_steps(
            {k: jnp.asarray(v) for k, v in resume_state.items()})
        snaps.append({k: np.asarray(v) for k, v in st.items()})
        out, state = E.align_batch_resume(cfg, pat, txt, plen, tlen, frees,
                                          max_steps, st)
    max_segments = (S_total + K - 2) // (K - 1) + 1
    snaps_bytes = 0
    for _ in range(max_segments):
        status = np.asarray(out["status"])  # sync: segment finished
        if not (status == E.ST_OVERFLOW_S).any():
            break
        snap = {k: np.asarray(v) for k, v in state.items()}
        snaps.append(snap)
        snaps_bytes += sum(a.nbytes for a in snap.values())
        # in-flight progress (verbose>=3 every probe_interval_global steps,
        # verbose>=4 every segment; reference: wavefront_unialign.c:110-112)
        if verbose >= 3:
            s_now = int(snap["s"])
            if verbose >= 4 or s_now >= next_probe:
                next_probe = (s_now // probe + 1) * probe
                _print_progress(cfg, B, s_now, snap, snaps_bytes)
        out, state = E.align_batch_resume(cfg, pat, txt, plen, tlen, frees,
                                          max_steps, state)
    n_segments = len(snaps) + 1

    meta = np.asarray(jnp.stack([out["status"], out["final_s"],
                                 out["end_k"], out["end_off"]]))
    status, final_s, end_k, end_off = meta
    mtbl = _mtbl_for(cfg)
    if capture is not None and (status == E.ST_MAX_STEPS).any():
        pb = PausedBatch()
        pb.attr, pb.attr0, pb.wildcard = attr, attr0, wildcard
        pb.patterns, pb.texts = patterns, texts
        pb.plens, pb.tlens = plens, tlens
        pb.full_probe, pb.Lp, pb.Lt = full_probe, Lp, Lt
        pb.cfg = cfg
        pb.snaps = snaps
        pb.state = {k: np.asarray(v) for k, v in state.items()}
        pb.B0 = B  # dispatch overwrites with the pre-padding size
        capture["paused"] = pb
    pen = attr0.penalties
    results = [None] * B
    oracle_idx = []
    escalate_idx = []
    at_full_W = cfg.W >= full_probe.W

    clean = (status == E.ST_END_REACHED)
    walkable = clean | ((status == E.ST_END_UNREACHABLE)
                        & (end_off > E.NULL_THRESHOLD))
    fb = np.zeros(B, dtype=bool)
    if scope_full and walkable.any():
        # walk highest segment first, rematerializing each block on device
        carry = E.walk_carry_init(final_s, end_k, jnp.asarray(walkable))
        blocks = [None] * n_segments
        # actual segment base scores (uniform K-1 apart in a plain run;
        # a resume boundary makes them irregular)
        bases = [0] + [int(sn["s"]) for sn in snaps]
        for i in range(n_segments - 1, -1, -1):
            s_now = np.asarray(carry[0])
            act = np.asarray(carry[3])
            if not (act & (s_now >= bases[i])).any():
                # no active pair has ops at this segment's levels
                blocks[i] = np.zeros((B, K), dtype=np.uint8)
                continue
            if i == 0:
                ops_seg, carry = E.align_batch_start_walk(
                    cfg_rec, pat, txt, plen, tlen, frees, max_steps, carry)
            else:
                st = {k: jnp.asarray(v) for k, v in snaps[i - 1].items()}
                ops_seg, carry = E.align_batch_replay_walk(
                    cfg_rec, pat, txt, plen, tlen, frees, max_steps, st,
                    carry)
            blocks[i] = np.asarray(ops_seg)
        # forward (ascending-level) order
        ops_all = np.concatenate(blocks, axis=1)
        k_start = np.asarray(carry[1])
        fb = np.asarray(carry[4]) | np.asarray(carry[3])
        n_ops = (ops_all != 0).sum(axis=1).astype(np.int64)
        native_ops = {}
        clean_idx = [b for b in range(B) if clean[b] and not fb[b]]
        if clean_idx:
            native_ops = _native_fill(cfg, clean_idx, pat_np, txt_np, plens,
                                      tlens, end_k, end_off, ops_all, n_ops,
                                      k_start, wildcard)

    extension = attr0.form.extension
    for b in range(B):
        st = int(status[b])
        if st == E.ST_END_REACHED and (not scope_full):
            s = int(final_s[b])
            sc = classic_score(pen, int(plens[b]), int(tlens[b]), s)
            results[b] = BatchResult(STATUS_ALG_COMPLETED, sc, "",
                                     int(plens[b]), int(tlens[b]), s, False)
        elif st == E.ST_END_REACHED and not fb[b]:
            s = int(final_s[b])
            ek = int(end_k[b])
            eoff = int(end_off[b])
            ev, eh = eoff - ek, eoff
            if b in native_ops:
                ops = native_ops[b]
            else:
                ops = _match_fill(patterns[b], texts[b], ops_all[b],
                                  int(n_ops[b]), int(k_start[b]),
                                  int(plens[b]), int(tlens[b]), wildcard,
                                  mtbl=mtbl)
                if eh < int(tlens[b]):
                    ops = ops + "I" * (int(tlens[b]) - eh)
                if ev < int(plens[b]):
                    ops = ops + "D" * (int(plens[b]) - ev)
            sc = classic_score(pen, ev, eh, s)
            if extension:
                results[b] = _maxtrim_result(pen, sc, ops, ev, eh, s)
            else:
                results[b] = BatchResult(STATUS_ALG_COMPLETED, sc, ops, ev,
                                         eh, s, False)
        elif st == E.ST_MAX_STEPS:
            results[b] = BatchResult(STATUS_MAX_STEPS_REACHED,
                                     -int(max_steps), "", 0, 0,
                                     int(final_s[b]), False)
        elif st == E.ST_END_UNREACHABLE and (
                not fb[b] or (scope_full and int(n_ops[b]) == 0)):
            s = int(final_s[b])
            ek = int(end_k[b])
            eoff = int(end_off[b])
            ops = ""
            if scope_full and eoff > E.NULL_THRESHOLD:
                ev, eh = eoff - ek, eoff
                if fb[b] or ev <= 0 or eh <= 0:
                    nm = min(ev, eh)
                    ops = ("I" * (eh - nm) + "D" * (ev - nm) + "M" * nm
                           + "I" * (int(tlens[b]) - eh)
                           + "D" * (int(plens[b]) - ev))
                else:
                    ops = _match_fill(patterns[b], texts[b], ops_all[b],
                                      int(n_ops[b]), int(k_start[b]),
                                      int(plens[b]), int(tlens[b]), wildcard,
                                      cap_h=eh, mtbl=mtbl)
                    if eh < int(tlens[b]):
                        ops = ops + "I" * (int(tlens[b]) - eh)
                    if ev < int(plens[b]):
                        ops = ops + "D" * (int(plens[b]) - ev)
            results[b] = _unreachable_result(pen, scope_full, s, ek, eoff,
                                             ops)
        elif st == E.ST_OVERFLOW_W and not at_full_W:
            escalate_idx.append(b)
        else:
            oracle_idx.append(b)

    if escalate_idx:
        # adaptive band: re-run outgrown pairs with a 4x wider band
        # (geometric, bounded by the worst-case width)
        next_W = min(full_probe.W, E._round_up(cfg.W * 4, 128))
        sub = align_pairs(attr, [patterns[b] for b in escalate_idx],
                          [texts[b] for b in escalate_idx], wildcard,
                          W=next_W, Lp=Lp, Lt=Lt, _escalated=True)
        for b, r in zip(escalate_idx, sub):
            results[b] = r

    if oracle_idx:
        for b in oracle_idx:
            results[b] = _oracle_one(attr, patterns[b], texts[b], wildcard)
    return results


class PausedBatch:
    """Retained checkpoint of a MAX_STEPS-paused segmented batch run.

    Produced by align_pairs_resumable when pairs hit the step cap; feed to
    align_pairs_resume with a raised cap to continue them from their
    retained wavefront rings (host-resident pytree snapshots) instead of
    realigning from scratch -- the batch analog of the reference's
    experimental resume (reference: wavefront_align.c:245-266).
    """

    __slots__ = ("attr", "attr0", "patterns", "texts", "wildcard", "cfg",
                 "plens", "tlens", "full_probe", "Lp", "Lt", "snaps",
                 "state", "B0")


def align_pairs_resumable(attr: AlignerAttributes, patterns, texts,
                          wildcard: Optional[int] = None, **kw):
    """align_pairs through the checkpointed segmented executor.

    Returns (results, paused): `paused` is None when every pair resolved,
    else a PausedBatch retaining the engine state of the pairs that hit
    `attr.system.max_alignment_steps` (their results carry status
    STATUS_MAX_STEPS_REACHED, score -max_steps). Continue with
    align_pairs_resume(paused, new_max_steps).
    """
    cap: dict = {}
    res = align_pairs_finish(align_pairs_dispatch(
        attr, patterns, texts, wildcard, _force_segmented=True,
        _capture=cap, **kw))
    return res, cap.get("paused")


def align_pairs_resume(paused: PausedBatch, max_steps: int):
    """Continue a MAX_STEPS-paused batch with a raised step cap.

    Completed/escalated pairs are re-assembled; paused pairs continue
    from the retained ring state (no recomputation of the forward loop
    below the pause score). Returns (results, paused2) like
    align_pairs_resumable; byte-equal to a fresh run at the raised cap
    (reference: wavefront_align.c:245-266 semantics).
    """
    raise_sys = lambda a: dataclasses.replace(
        a, system=dataclasses.replace(a.system,
                                      max_alignment_steps=max_steps))
    attr = raise_sys(paused.attr)
    attr0 = raise_sys(paused.attr0)
    cap: dict = {}
    res = _align_pairs_remat(
        attr, attr0, paused.patterns, paused.texts, paused.wildcard,
        paused.cfg, paused.plens, paused.tlens, paused.full_probe,
        paused.Lp, paused.Lt, resume_snaps=paused.snaps,
        resume_state=paused.state, resume_cfg=paused.cfg, capture=cap)
    paused2 = cap.get("paused")
    if paused2 is not None:
        paused2.B0 = paused.B0
    return res[:paused.B0], paused2


class BatchWavefrontAligner:
    """Batched aligner: many pattern/text pairs per call.

    Configuration kwargs match `WavefrontAligner`; alignment happens in
    length-bucketed, statically-shaped batches on the accelerator, with
    automatic escalation for pairs that exceed a bucket's band/score budget
    and oracle fallback for dropped/partial alignments (so heuristic and
    failure semantics stay byte-faithful to the reference).
    """

    def __init__(self, W: Optional[int] = None, S_cap: Optional[int] = None,
                 **kwargs):
        from .align import WavefrontAligner
        self._api = WavefrontAligner(backend="numpy", **kwargs)
        self._W = W
        self._S_cap = S_cap

    def align(self, patterns: Sequence[str], texts: Sequence[str]
              ) -> List[BatchResult]:
        bp = [p.upper().encode("ascii") for p in patterns]
        bt = [t.upper().encode("ascii") for t in texts]
        attr = self._api._attributes()
        wc = None
        if self._api._wildcard:
            wc = self._api._bwildcard
        return align_pairs(attr, bp, bt, wildcard=wc,
                           W=self._W, S_cap=self._S_cap)

    def align_stream(self, batches, depth: int = 3):
        """Pipelined align over an iterable of (patterns, texts[, kwargs])
        batches; yields one List[BatchResult] per input batch. Keeps
        `depth` batches in flight (see align_pairs_stream)."""
        attr = self._api._attributes()
        wc = self._api._bwildcard if self._api._wildcard else None

        def to_bytes(seqs):
            return [s.upper().encode("ascii") if isinstance(s, str) else s
                    for s in seqs]

        def gen():
            for item in batches:
                yield (to_bytes(item[0]), to_bytes(item[1])) + tuple(item[2:])

        return align_pairs_stream(attr, gen(), wildcard=wc, depth=depth,
                                  W=self._W, S_cap=self._S_cap)

    def align_packed2bits(self, packed_patterns, pattern_lengths,
                          packed_texts, text_lengths) -> List[BatchResult]:
        """Align 2-bit-packed DNA pairs (analog of the reference's
        `wavefront_align_packed2bits`, wavefront_align.c:150-241)."""
        from .utils.encode import unpack2bits
        bp = [unpack2bits(p, n) for p, n in
              zip(packed_patterns, pattern_lengths)]
        bt = [unpack2bits(t, n) for t, n in
              zip(packed_texts, text_lengths)]
        attr = self._api._attributes()
        return align_pairs(attr, bp, bt, W=self._W, S_cap=self._S_cap)


# (attr0, shape...) -> (full_probe, cfg, at_full_caps); see dispatch
_CFG_MEMO: dict = {}

# constant device arrays reused across batches (uniform lens, zero frees,
# max_steps scalars): each jnp.full/zeros/int32 would otherwise be one
# more device operation per batch. jax.Arrays are immutable, so sharing
# across dispatches is safe.
_DEV_CONST_CACHE: dict = {}


def _dev_const(kind, *key):
    import jax.numpy as jnp
    k = (kind,) + key
    arr = _DEV_CONST_CACHE.get(k)
    if arr is None:
        if kind == "full":
            B, v = key
            arr = jnp.full((B,), v, dtype=jnp.int32)
        elif kind == "zeros2":
            B, n = key
            arr = jnp.zeros((B, n), dtype=jnp.int32)
        else:  # "i32" scalar
            arr = jnp.int32(key[0])
        if len(_DEV_CONST_CACHE) > 256:
            _DEV_CONST_CACHE.clear()
        _DEV_CONST_CACHE[k] = arr
    return arr


def _band_for_score(attr, S: int, maxLp: int, maxLt: int) -> int:
    """Band width sufficient for any alignment of score <= S.

    The wavefront band grows at most one diagonal per side per
    gap-extension chain step, so after S score units it spans at most
    +-ceil(S/e_min) around k=0 (e_min = cheapest per-base gap cost of the
    metric), plus the target-diagonal offset; padded like full_config.
    Ends-free WF0 seeds additionally occupy [-pattern_begin_free,
    text_begin_free] at score 0 (reference: wavefront_aligner.c:277-302),
    which sets a floor independent of S. Undersized bands are safe: band
    or seed overflow reports ST_OVERFLOW_W and the pair escalates.
    """
    from .constants import DistanceMetric
    pen = attr.penalties
    pad = pen.max_score_scope + 4
    m = pen.distance_metric
    if m == DistanceMetric.GAP_AFFINE:
        den = max(1, pen.gap_extension1)
    elif m == DistanceMetric.GAP_AFFINE_2P:
        den = max(1, min(pen.gap_extension1, pen.gap_extension2))
    elif m == DistanceMetric.GAP_LINEAR:
        den = max(1, pen.gap_opening1)
    else:
        den = 1
    reach = min(S, S // den + 1)
    band = 2 * (reach + abs(maxLp - maxLt)) + 2 * pad + 8
    # band-limiting heuristics bound the LIVE band regardless of score,
    # and per-step device cost is proportional to the STATIC band W (the
    # fixed-width tensor is processed whole every step) -- so cap W from
    # the heuristic's own bound or pruning saves nothing. wfadaptive
    # keeps diagonals within max_distance_threshold of the best
    # (reference: wavefront_heuristic.c:176-293); banded clamps to
    # [min_k, max_k] (:454-505). Undersized caps are safe: overflow
    # escalates 4x wider.
    h = attr.heuristic
    strat = int(h.strategy)
    diff2 = 2 * abs(maxLp - maxLt)
    if strat & int(HeuristicStrategy.WFADAPTIVE | HeuristicStrategy.WFMASH):
        band = min(band, 2 * h.max_distance_threshold
                   + h.min_wavefront_length + diff2 + 2 * pad + 72)
    if strat & int(HeuristicStrategy.XDROP):
        # x-drop prunes diagonals whose SW score lags the best by xdrop;
        # score falls ~gap_e per diagonal off the best path, so the live
        # band stays within ~xdrop/gap_e of it (+ drift margin)
        ge = max(1, attr.penalties.internal_gap_e)
        band = min(band, 4 * (h.xdrop // ge + 1) + diff2 + 2 * pad + 128)
    if strat & int(HeuristicStrategy.BANDED_STATIC
                   | HeuristicStrategy.BANDED_ADAPTIVE):
        band = min(band, (h.max_k - h.min_k) + diff2 + 2 * pad + 8)
    f = attr.form
    if f.span == AlignmentSpan.ENDS_FREE and not f.extension:
        seed = (min(f.pattern_begin_free, maxLp)
                + min(f.text_begin_free, maxLt))
        band = max(band, 2 * seed + 2 * pad + 8)
    return band


def _bucket_len(n: int) -> int:
    """Round a padded sequence length up to a ~6%-granular bucket so
    compile-cache keys stay stable across batches with jittery max
    lengths (each distinct shape costs a fresh compile)."""
    if n <= 64:
        return 64
    q = 1 << max(4, n.bit_length() - 4)
    return -(-n // q) * q


def _bucket_B(n: int) -> int:
    """Round a batch size up to the next power of two (>= 16): escalation
    re-runs and user streams produce jittery batch sizes, and every
    distinct B is a fresh compile. Pad pairs are trivial ("A" vs "A")."""
    if n <= 16:
        return 16
    return 1 << (n - 1).bit_length()


class _Inflight:
    """A dispatched batch: device work enqueued, host assembly pending.

    Produced by align_pairs_dispatch, consumed by align_pairs_finish. When
    the batch resolved eagerly on the host (extension mode, segmented
    execution), `results` is already set and the device fields are unused.
    """

    __slots__ = ("results", "attr", "attr0", "cfg", "full_probe", "patterns",
                 "texts", "wildcard", "plens", "tlens", "pat_np", "txt_np",
                 "max_steps_i", "scope_full", "at_full_caps", "Lp", "Lt",
                 "maxLp", "maxLt", "B", "B0", "meta_d", "packed_d",
                 "meta_np", "packed_np")

    def __init__(self, results=None):
        self.results = results
        self.meta_np = None
        self.packed_np = None


def align_pairs(attr: AlignerAttributes, patterns: Sequence[bytes],
                texts: Sequence[bytes], wildcard: Optional[int] = None,
                W: Optional[int] = None, S_cap: Optional[int] = None,
                Lp: Optional[int] = None, Lt: Optional[int] = None,
                _escalated: bool = False) -> List[BatchResult]:
    """Align B pairs through the JAX engine; returns per-pair BatchResult.

    Lp/Lt: padded token-array lengths (>= max sequence length); pass bucketed
    values to stabilize compile-cache hits across calls. When W/S_cap are not
    given, an optimistic score cap is chosen and pairs exceeding it escalate
    through a geometric ladder (compute is proportional to the *reached*
    score, preserving WFA's O(ns+s^2) behavior on easy pairs).
    """
    return align_pairs_finish(align_pairs_dispatch(
        attr, patterns, texts, wildcard, W=W, S_cap=S_cap, Lp=Lp, Lt=Lt,
        _escalated=_escalated))


def align_pairs_stream(attr: AlignerAttributes, batches, wildcard=None,
                       depth: int = 3, workers: int = 1, **kw):
    """Pipelined batch alignment: yields one List[BatchResult] per input
    batch, keeping up to `depth` batches in flight so host CIGAR assembly
    of batch N overlaps device compute + transfers of batches N+1..N+depth.

    `workers` > 0 runs the device PULL on one helper thread so the wait
    for a not-yet-ready result (device completion + transfer) overlaps
    the caller's host work; the wait releases the GIL, so this costs no
    CPU. The CPU-heavy finish stage (native match-fill, result assembly,
    escalation re-runs) stays on the CALLING thread: on a 2-core host,
    worker threads doing real CPU work fought the dispatch stage for
    cores and ran the pipeline ~2x slower, so only the blocking wait is
    offloaded. Results come back in input order. `workers=0` runs
    everything on the caller's thread.

    At stream start the current heap is gc.freeze()-frozen: each batch
    allocates thousands of short-lived result objects, and the periodic
    full gen-2 collection they trigger scans every live object -- a
    measured ~100 ms pause every ~12 batches at the headline shape, ~30%
    of stream wall time. Freezing moves the long-lived baseline (jax
    internals, compiled executables) out of the collector's reach, so
    collections keep running (consumer cycles are still reclaimed, and
    concurrent streams don't fight over a global disable) but scan only
    the small unfrozen working set. The stream's own objects are acyclic
    and die by refcount either way. Set PYWFA_STREAM_GC=1 to skip the
    freeze (frozen objects stay uncollectable for the process lifetime,
    which matters only if the pre-stream heap itself held collectable
    cycles).

    Each input item is (patterns, texts) or (patterns, texts, kwargs) --
    the per-batch kwargs (e.g. bucketed Lp/Lt) override the stream-level
    **kw for that dispatch.
    """
    import collections
    import gc
    pending = collections.deque()
    if os.environ.get("PYWFA_STREAM_GC", "") in ("", "0"):
        gc.collect()
        gc.freeze()
    ex = None
    if workers > 0:
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(max_workers=1)
    try:
        for item in batches:
            patterns, texts = item[0], item[1]
            bkw = dict(kw, **item[2]) if len(item) > 2 else kw
            h = align_pairs_dispatch(attr, patterns, texts, wildcard, **bkw)
            pending.append(ex.submit(align_pairs_pull, h) if ex else h)
            if len(pending) > depth:
                head = pending.popleft()
                yield align_pairs_finish(head.result() if ex else head)
        while pending:
            head = pending.popleft()
            yield align_pairs_finish(head.result() if ex else head)
    finally:
        if ex is not None:
            ex.shutdown(wait=True)


def align_pairs_dispatch(attr: AlignerAttributes, patterns: Sequence[bytes],
                         texts: Sequence[bytes],
                         wildcard: Optional[int] = None,
                         W: Optional[int] = None, S_cap: Optional[int] = None,
                         Lp: Optional[int] = None, Lt: Optional[int] = None,
                         _escalated: bool = False,
                         _force_segmented: bool = False,
                         _capture: Optional[dict] = None) -> _Inflight:
    """Phase 1 of align_pairs: encode, push, enqueue the device score loop +
    traceback walk + single packed output transfer. Returns without blocking
    on the device (JAX async dispatch)."""
    B0 = len(patterns)
    assert B0 == len(texts)
    if B0 == 0:
        return _Inflight(results=[])
    t0 = time.perf_counter() if _PROF else 0.0
    # batch-size bucketing: pad to a power of two with trivial pairs so
    # jittery batch sizes (escalation re-runs, user stream tails) hit the
    # compile cache instead of compiling a fresh program per distinct B
    B = _bucket_B(B0)
    if B != B0:
        patterns = list(patterns) + [b"A"] * (B - B0)
        texts = list(texts) + [b"A"] * (B - B0)
    # fromiter(map(len,...)) is ~5x cheaper than np.array(listcomp) at
    # B=4096 (~1.2 ms/batch saved across both sides)
    plens = np.fromiter(map(len, patterns), dtype=np.int32, count=B)
    tlens = np.fromiter(map(len, texts), dtype=np.int32, count=B)
    maxLp = int(plens.max()) if B else 0
    maxLt = int(tlens.max()) if B else 0
    # batch semantics: ends-free slack is clamped per pair (the reference
    # aborts the process instead, wavefront_align.c:90-103); clamp before
    # validation so mixed-length batches pass
    f = attr.form
    if f.span == AlignmentSpan.ENDS_FREE and not f.extension:
        attr = dataclasses.replace(attr, form=dataclasses.replace(
            f,
            pattern_begin_free=min(f.pattern_begin_free, maxLp),
            pattern_end_free=min(f.pattern_end_free, maxLp),
            text_begin_free=min(f.text_begin_free, maxLt),
            text_end_free=min(f.text_end_free, maxLt)))
    attr0 = validate_alignment(attr, maxLp, maxLt)
    scope_full = attr0.scope == AlignmentScope.COMPUTE_ALIGNMENT
    # memory modes scale the on-device traceback budget; med/low/ultralow
    # force earlier segmentation (the reference's memory ladder,
    # wavefront_aligner.c:101-122, re-expressed for tensor storage)
    caps = device_mem_caps()
    choices_cap = caps.choices // {
        MemoryMode.HIGH: 1, MemoryMode.MED: 4,
        MemoryMode.LOW: 16, MemoryMode.ULTRALOW: 64,
    }[attr0.memory_mode]
    # padded-length bucketing: stable compile-cache keys across batches
    # with jittery max lengths (an explicit Lp/Lt arg still wins if larger)
    Lp = max(Lp or 0, _bucket_len(maxLp))
    Lt = max(Lt or 0, _bucket_len(maxLt))
    # config derivation memo: validate/full_config/rung selection costs
    # ~1.5 ms per batch, a measurable slice of a ~20 ms pipelined batch
    memo_key = (attr0, Lp, Lt, min(maxLp, maxLt), W, S_cap, wildcard,
                scope_full, _escalated)
    memo = _CFG_MEMO.get(memo_key)
    if memo is not None:
        full_probe, cfg, at_full_caps = memo
    else:
        full_probe = E.full_config(attr0, Lp, Lt, record_choices=scope_full)
        # optimistic first rung, scaled to the read length (typical scores
        # run ~L*divergence*cost, far below the worst case); escalation
        # handles the tail. The band is sized for the rung's score via the
        # gap-extension growth rate, NOT the worst case -- at the 150bp
        # headline this is W=128 vs the 512 a worst-case band would cost,
        # a ~4x cut in per-step device work.
        S0 = max(96, E._round_up(min(maxLp, maxLt) // 6 + 1, 32))
        if (W is None and S_cap is None and full_probe.S_cap > S0
                and not _escalated):
            S_cap = min(S0, full_probe.S_cap)
            W = min(full_probe.W,
                    E._round_up(_band_for_score(attr0, S_cap, Lp, Lt), 128))
        cfg = E.full_config(attr0, Lp, Lt,
                            wildcard=(wildcard if wildcard is not None
                                      else -1),
                            W=W, S_cap=S_cap, record_choices=scope_full)
        at_full_caps = (cfg.S_cap >= full_probe.S_cap
                        and cfg.W >= full_probe.W)
        if scope_full and not at_full_caps:
            # compacted 4-bit walk-op pull (see EngineConfig.ops_out);
            # pairs with more ops than this re-run at the next rung
            # (guaranteed to fit there: next ops_out >= 4*S_cap//3 >=
            # S_cap >= n_ops)
            oc = min(cfg.S_cap, max(32, E._round_up(cfg.S_cap // 3, 2)))
            if oc < cfg.S_cap:
                cfg = dataclasses.replace(cfg, ops_out=oc)
        if len(_CFG_MEMO) > 512:
            _CFG_MEMO.clear()
        _CFG_MEMO[memo_key] = (full_probe, cfg, at_full_caps)
    lcp_bytes = 3 * B * cfg.W * (cfg.Lt + cfg.extend_chunk)
    if lcp_bytes > caps.lcp_table:
        cfg = dataclasses.replace(cfg, use_lcp_table=False)
    if ((scope_full and cfg.S_cap * B * cfg.W > choices_cap)
            or _force_segmented):
        # the device can't hold the whole traceback record: run
        # segmented with rematerialized traceback. Segments lift the
        # score cap entirely; the band stays at this rung's width (pairs
        # that outgrow it escalate geometrically inside
        # _align_pairs_remat).
        res = _align_pairs_remat(attr, attr0, patterns, texts, wildcard,
                                 cfg, plens, tlens, full_probe, Lp, Lt,
                                 capture=_capture)
        if _capture is not None and "paused" in _capture:
            _capture["paused"].B0 = B0
        return _Inflight(results=res[:B0])
    C = cfg.extend_chunk
    if _PROF:
        t0 = _prof_add("d.config", t0)

    pat_np, pp = _encode_side(patterns, cfg.Lp, C, PATTERN_SENTINEL, plens)
    txt_np, pt = _encode_side(texts, cfg.Lt, C, TEXT_SENTINEL, tlens)
    if _PROF:
        t0 = _prof_add("d.encode", t0)
    # uniform-length / all-zero side arrays are cached device constants
    # (_dev_const), not pushed per batch
    def _push_lens(a):
        v = int(a[0])
        if (a == v).all():
            return _dev_const("full", B, v)
        return jnp.asarray(a)
    plen = _push_lens(plens)
    tlen = _push_lens(tlens)
    frees_np = _build_frees(attr0, B, plens, tlens)
    frees = (_dev_const("zeros2", B, 4) if not frees_np.any()
             else jnp.asarray(frees_np))
    max_steps_i = min(attr0.system.max_alignment_steps, 2**31 - 1)
    max_steps = _dev_const("i32", max_steps_i)

    # ONE compiled call producing ONE packed output array (walk + meta
    # packing run inside the same program as the score loop), pulled in
    # ONE device->host transfer
    out_d = _run_engine(cfg, pat_np, txt_np, plen, tlen, frees, max_steps,
                        scope_full=scope_full, pp=pp, pt=pt)
    if _PROF:
        t0 = _prof_add("d.push_enqueue", t0)
    h = _Inflight()
    if scope_full:
        h.packed_d = out_d
        h.meta_d = None
        # start the device->host copy as soon as the result materializes so
        # the transfer overlaps the next batch's compute
        h.packed_d.copy_to_host_async()
    else:
        h.meta_d = out_d
        h.packed_d = None
        out_d.copy_to_host_async()
    h.attr, h.attr0, h.cfg, h.full_probe = attr, attr0, cfg, full_probe
    h.patterns, h.texts, h.wildcard = patterns, texts, wildcard
    h.plens, h.tlens, h.pat_np, h.txt_np = plens, tlens, pat_np, txt_np
    h.max_steps_i = max_steps_i
    h.scope_full, h.at_full_caps = scope_full, at_full_caps
    h.Lp, h.Lt, h.maxLp, h.maxLt, h.B, h.B0 = Lp, Lt, maxLp, maxLt, B, B0
    return h


def align_pairs_pull(h: _Inflight) -> _Inflight:
    """Materialize the device output of a dispatched batch on the CALLING
    thread. In a deep-enough pipeline the async device->host copy started
    at dispatch has already completed and this costs ~nothing.
    Idempotent; finish() pulls itself if this was never called."""
    if h.results is None:
        t0 = time.perf_counter() if _PROF else 0.0
        if h.packed_d is not None:
            h.packed_np = np.asarray(h.packed_d)
            h.packed_d = None
        elif h.meta_d is not None:
            h.meta_np = np.asarray(h.meta_d)
            h.meta_d = None
        if _PROF:
            # on the puller thread this wait overlaps the caller's host
            # work (off the critical path); recorded for the profile
            _prof_add("p.pull_wait", t0)
    return h


def align_pairs_finish(h: _Inflight) -> List[BatchResult]:
    """Phase 2 of align_pairs: pull the packed device output, assemble
    CIGARs (native match-fill), escalate/fall back the rare tail."""
    if h.results is not None:
        return h.results
    attr, attr0, cfg, full_probe = h.attr, h.attr0, h.cfg, h.full_probe
    patterns, texts, wildcard = h.patterns, h.texts, h.wildcard
    plens, tlens, pat_np, txt_np = h.plens, h.tlens, h.pat_np, h.txt_np
    scope_full, at_full_caps = h.scope_full, h.at_full_caps
    Lp, Lt, maxLp, maxLt, B = h.Lp, h.Lt, h.maxLp, h.maxLt, h.B
    max_steps = h.max_steps_i
    results: List[Optional[BatchResult]] = [None] * B
    pen = attr0.penalties
    t0 = time.perf_counter() if _PROF else 0.0

    if scope_full:
        packed = (h.packed_np if h.packed_np is not None
                  else np.asarray(h.packed_d))
        if E.packed_layout(cfg) == "compact":
            # 14-byte meta + 4-bit op stream (see engine.packed_layout)
            status = packed[:B].astype(np.int32)
            fb = packed[B: 2 * B] != 0
            m16 = packed[2 * B: 10 * B].view(np.int16).reshape(4, B)
            final_s, end_k, n_ops, k_start = (
                m16.astype(np.int32))  # widen once
            end_off = packed[10 * B: 14 * B].view(np.int32)
            ops4 = packed[14 * B:].reshape(B, cfg.ops_out // 2)
            ops_fwd = np.empty((B, cfg.ops_out), dtype=np.uint8)
            ops_fwd[:, 0::2] = ops4 & 0xF
            ops_fwd[:, 1::2] = ops4 >> 4
        else:
            meta = packed[: 7 * B * 4].view(np.int32).reshape(7, B)
            ops_fwd = packed[7 * B * 4:].reshape(B, cfg.S_cap)
            status, final_s, end_k, end_off, n_ops, k_start = meta[:6]
            fb = meta[6] != 0
    else:
        meta = h.meta_np if h.meta_np is not None else np.asarray(h.meta_d)
        status, final_s, end_k, end_off = meta
        fb = np.zeros(B, dtype=bool)
    if _PROF:
        t0 = _prof_add("f.pull", t0)

    oracle_idx: List[int] = []
    escalate_idx: List[int] = []
    mtbl = _mtbl_for(cfg)

    # clean full-CIGAR pairs: batched native match-fill when available
    clean_np = (status == E.ST_END_REACHED) & ~fb
    native_ops: dict = {}
    if scope_full:
        clean_idx = np.flatnonzero(clean_np).tolist()
        if clean_idx:
            native_ops = _native_fill(cfg, clean_idx, pat_np, txt_np, plens,
                                      tlens, end_k, end_off, ops_fwd, n_ops,
                                      k_start, wildcard)
        # dropped pairs with a walked backtrace: same batched fill, final
        # run forced to the recorded historic-max offset
        part_np = ((status == E.ST_END_UNREACHABLE) & ~fb
                   & (end_off > E.NULL_THRESHOLD)
                   & ((end_off - end_k) > 0) & (end_off > 0))
        part_idx = np.flatnonzero(part_np).tolist()
        if part_idx:
            native_ops.update(_native_fill(
                cfg, part_idx, pat_np, txt_np, plens, tlens, end_k, end_off,
                ops_fwd, n_ops, k_start, wildcard, capped=True))
    if _PROF:
        t0 = _prof_add("f.native_fill", t0)

    # vectorized score translation + python-int views (np scalar indexing in
    # a 4096-iteration loop costs several ms)
    ev_a = end_off - end_k
    eh_a = end_off
    from .attributes import classic_score_batch
    if scope_full:
        sc_a = classic_score_batch(pen, ev_a, eh_a, final_s).tolist()
    else:
        sc_a = classic_score_batch(pen, plens, tlens, final_s).tolist()
    status_l = status.tolist()
    final_s_l = final_s.tolist()
    ev_l = ev_a.tolist()
    eh_l = eh_a.tolist()
    plens_l = plens.tolist()
    tlens_l = tlens.tolist()
    fb_l = fb.tolist()

    extension = attr0.form.extension
    end_off_l = end_off.tolist() if scope_full else eh_l

    # fast path for the overwhelmingly common batch: every pair completed
    # cleanly and the native fill produced every CIGAR -- build results in
    # one comprehension (the general per-pair branch chain below costs
    # ~2x more at B=4096, a measurable slice of a pipelined stream batch)
    if (scope_full and not extension and len(native_ops) == B
            and bool(clean_np.all())):
        ST = STATUS_ALG_COMPLETED
        ops_get = native_ops.__getitem__
        results = [BatchResult(ST, sc, ops_get(b), ev, eh, s, False)
                   for b, sc, ev, eh, s in
                   zip(range(B), sc_a, ev_l, eh_l, final_s_l)]
        if _PROF:
            _prof_add("f.assemble", t0)
        return results[:h.B0]

    for b in range(B):
        st = status_l[b]
        if st == E.ST_END_REACHED and (not scope_full):
            results[b] = BatchResult(STATUS_ALG_COMPLETED, sc_a[b], "",
                                     plens_l[b], tlens_l[b], final_s_l[b],
                                     False)
        elif st == E.ST_END_REACHED and not fb_l[b]:
            s = final_s_l[b]
            ev, eh = ev_l[b], eh_l[b]
            if b in native_ops:
                ops = native_ops[b]
            else:
                ops = _match_fill(patterns[b], texts[b], ops_fwd[b],
                                  int(n_ops[b]), int(k_start[b]),
                                  plens_l[b], tlens_l[b], wildcard,
                                  mtbl=mtbl)
                # ends-free: trailing free ops, I-block then D-block
                # (reference: backtrace.c:347-356 writes D's rightmost)
                if eh < tlens_l[b]:
                    ops = ops + "I" * (tlens_l[b] - eh)
                if ev < plens_l[b]:
                    ops = ops + "D" * (plens_l[b] - ev)
            if extension:
                results[b] = _maxtrim_result(pen, sc_a[b], ops, ev, eh, s)
            else:
                results[b] = BatchResult(STATUS_ALG_COMPLETED, sc_a[b], ops,
                                         ev, eh, s, False)
        elif st == E.ST_MAX_STEPS:
            results[b] = BatchResult(STATUS_MAX_STEPS_REACHED,
                                     -max_steps, "", 0, 0,
                                     final_s_l[b], False)
        elif st in (E.ST_OVERFLOW_W, E.ST_OVERFLOW_S) and not at_full_caps:
            escalate_idx.append(b)
        elif st == E.ST_END_UNREACHABLE and (
                not fb_l[b] or (scope_full and int(n_ops[b]) == 0)):
            # dropped (z-drop) / heuristic dead-end: native assembly
            # (reference: wavefront_unialign.c:158-173,211-235)
            s = final_s_l[b]
            eoff = end_off_l[b]
            ops = ""
            if scope_full and eoff > E.NULL_THRESHOLD:
                ev, eh = ev_l[b], eh_l[b]
                if fb_l[b] or ev <= 0 or eh <= 0:
                    # end cell on the matrix boundary, or all backtrace
                    # candidates null at the end cell itself (fb with zero
                    # walked ops): the reference's loop exits immediately
                    # and writes the forced beginning fill
                    # (reference: wavefront_backtrace.c:347-356,505-525)
                    nm = min(ev, eh)
                    ops = ("I" * (eh - nm) + "D" * (ev - nm) + "M" * nm
                           + "I" * (tlens_l[b] - eh)
                           + "D" * (plens_l[b] - ev))
                elif b in native_ops:
                    ops = native_ops[b]
                else:
                    ops = _match_fill(patterns[b], texts[b], ops_fwd[b],
                                      int(n_ops[b]), int(k_start[b]),
                                      plens_l[b], tlens_l[b], wildcard,
                                      cap_h=eh, mtbl=mtbl)
                    if eh < tlens_l[b]:
                        ops = ops + "I" * (tlens_l[b] - eh)
                    if ev < plens_l[b]:
                        ops = ops + "D" * (plens_l[b] - ev)
            results[b] = _unreachable_result(pen, scope_full, s,
                                             int(end_k[b]), eoff, ops)
        else:
            # inconsistent walk (rare) -> exact oracle
            oracle_idx.append(b)
    if _PROF:
        t0 = _prof_add("f.assemble", t0)

    if escalate_idx:
        # geometric escalation: 4x the score cap, band sized to match
        if attr0.system.verbose >= 3:
            print(f"[pywfa_tpu::align] escalating {len(escalate_idx)}/{B} "
                  f"pairs past bucket (W={cfg.W}, S_cap={cfg.S_cap})",
                  file=sys.stderr, flush=True)
        sub_p = [patterns[b] for b in escalate_idx]
        sub_t = [texts[b] for b in escalate_idx]
        next_S = min(cfg.S_cap * 4, full_probe.S_cap)
        if next_S >= full_probe.S_cap:
            next_W, next_S = None, None  # terminal rung: worst-case caps
        else:
            # at least 2x band growth per rung: heuristic-capped bands
            # (_band_for_score) are score-independent, and W-overflow
            # pairs must not re-run at an unchanged width
            next_W = min(full_probe.W, E._round_up(
                max(_band_for_score(attr0, next_S, maxLp, maxLt),
                    cfg.W * 2), 128))
        sub = align_pairs(attr, sub_p, sub_t, wildcard,
                          W=next_W, S_cap=next_S, Lp=Lp, Lt=Lt,
                          _escalated=True)
        for b, r in zip(escalate_idx, sub):
            results[b] = r
        if _PROF:
            t0 = _prof_add("f.escalate", t0)

    if oracle_idx:
        for b in oracle_idx:
            results[b] = _oracle_one(attr, patterns[b], texts[b], wildcard)
        if _PROF:
            t0 = _prof_add("f.oracle", t0)

    return results[:h.B0]  # type: ignore[return-value]
