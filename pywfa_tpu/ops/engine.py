"""Batched wavefront-alignment engine (JAX/XLA).

The reference's one-pair-at-a-time, pointer-rich C engine
(reference: wavefront_unialign.c:241-273 score loop) is re-designed here as a
batched SPMD tensor program:

- Wavefronts live in a dense ring buffer `offsets[comp, scope, B, W]`
  (scope = max_score_scope, exactly the reference's modular memory,
  wavefront_components.c:92-93). NULL = -2^30 sentinel.
- The score loop is a `jax.lax.while_loop`; per-pair completion is masked.
- Extension is a vectorized chunked compare over all diagonals of all pairs.
- The M/I/D compute is shift+max over the band (wavefront_compute_affine.c:44-86).
- Traceback: instead of the reference's pointer-chasing high-memory backtrace
  (wavefront_backtrace.c:320-504) or pcigar blocks, each compute step records
  a one-byte `choice` per cell encoding the argmax source under the exact
  reference tie priorities (M > D2e > D2o > D1e > D1o > I2e > I2o > I1e >
  I1o, wavefront_backtrace.c:49-59). A `lax.scan` walks the choice tensor
  backwards to an op stream; match runs are re-derived greedily forward
  (the same trick as the reference's pcigar unpack, wavefront_pcigar.c).

Everything is static-shaped: band width W, score cap S_cap and batch B are
compile-time constants; band/score overflow is detected and reported so the
host can escalate to a bigger bucket.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    AlignmentSpan,
    DistanceMetric,
    HeuristicStrategy,
    OFFSET_NULL,
)

# numpy (not jnp) scalar: creating a device constant at import time would
# initialize the XLA backend, which must not happen before
# jax.distributed.initialize in multi-process runs (tools/mp_worker.py)
NULL = np.int32(OFFSET_NULL)
NULL_THRESHOLD = OFFSET_NULL // 2
INT32_MAX = 2**31 - 1

# internal engine statuses (per pair)
ST_RUNNING = 0
ST_END_REACHED = 1       # alignment end reached (clean completion)
ST_END_UNREACHABLE = 2   # heuristic dead-end / z-drop
ST_MAX_STEPS = 3         # user max_alignment_steps hit
ST_OVERFLOW_W = 4        # band exceeded W -> escalate bucket
ST_OVERFLOW_S = 5        # S_cap exceeded -> escalate bucket

# component indices
M, I1, D1, I2, D2 = 0, 1, 2, 3, 4

# choice byte layout: bits 0-2 = M source, bit 3 = I1 ext, bit 4 = D1 ext,
# bit 5 = I2 ext, bit 6 = D2 ext
MSRC_NONE, MSRC_X, MSRC_I1, MSRC_D1, MSRC_I2, MSRC_D2, MSRC_SEED = 0, 1, 2, 3, 4, 5, 7

# walk op codes (op stream emitted by traceback walk)
WOP_END, WOP_X, WOP_I, WOP_D = 0, 1, 2, 3
WOP_MFLAG = 4  # bit: op preceded by a (greedy) match run

# sequence padding sentinels: distinct values so padded tails never match
# (the tensor analog of WFA2-lib's '!'/'?' EOS bytes,
# wavefront_sequences.c:37-39)
PATTERN_PAD = 1
TEXT_PAD = 2

# element cap for any one skew-trick intermediate in the LCP-table builder:
# int32 linearized addressing has corrupted results past ~2^31 elements,
# so the band is built in chunks well below that (_build_lcp_table)
LCP_BUILD_ELEMS_CAP = 2**29


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static (compile-time) engine configuration."""

    metric: DistanceMetric
    # internal (post-Eizenga) penalties
    match: int
    mismatch: int
    gap_opening1: int
    gap_extension1: int
    gap_opening2: int
    gap_extension2: int
    span: AlignmentSpan
    # heuristics
    strategy: int = 0  # HeuristicStrategy bitmask
    min_wavefront_length: int = 10
    max_distance_threshold: int = 50
    steps_between_cutoffs: int = 1
    xdrop: int = 20
    zdrop: int = 20
    band_min_k: int = -10
    band_max_k: int = 10
    internal_gap_e: int = 2
    # shapes
    W: int = 256          # band width (diagonals)
    S_cap: int = 128      # max score steps this bucket supports
    Lp: int = 160         # padded pattern length
    Lt: int = 160         # padded text length
    # behavior
    record_choices: bool = True
    extend_chunk: int = 16
    wildcard: int = -1    # >= 0: wildcard byte code
    # name of a registered match-equivalence class table ("" = exact);
    # chars match iff their class masks intersect (the tensor form of the
    # reference's lambda cmp, wavefront_sequences.c:228-252)
    match_classes: str = ""
    # Precompute per-diagonal LCP run lengths (memory O(B*W*Lt), turns the
    # extension into one tiny gather per step -- the batched answer to the
    # reference's per-diagonal scalar LCP loop). Disable for long reads
    # where the table would not fit.
    use_lcp_table: bool = True
    # extension formulation override ("" = auto; see _extend_mode). Part
    # of the config so each mode compiles/caches separately.
    extend_force: str = ""
    # Compacted walk-op output width (even; 0 = off). When 0 < ops_out <
    # S_cap, _pack_full compacts each pair's zero-sparse [S_cap] op stream
    # to its first ops_out tokens and 4-bit packs them (tokens are 3 bits),
    # shrinking the device->host pull ~6x. Pairs with
    # more than ops_out ops report ST_OVERFLOW_S and re-run at the next
    # escalation rung (n_ops <= final_s <= S_cap bounds the rung above).
    ops_out: int = 0

    @property
    def n_comp(self) -> int:
        if self.metric == DistanceMetric.GAP_AFFINE:
            return 3
        if self.metric == DistanceMetric.GAP_AFFINE_2P:
            return 5
        return 1

    @property
    def scope(self) -> int:
        m = self.metric
        if m in (DistanceMetric.INDEL, DistanceMetric.EDIT):
            return 2
        if m == DistanceMetric.GAP_LINEAR:
            return max(self.mismatch, self.gap_opening1) + 1
        if m == DistanceMetric.GAP_AFFINE:
            return max(self.gap_opening1 + self.gap_extension1, self.mismatch) + 1
        return max(max(self.gap_opening1 + self.gap_extension1,
                       self.gap_opening2 + self.gap_extension2),
                   self.mismatch) + 1

    @property
    def kmin(self) -> int:
        return -(self.W // 2)


def full_config(attr, plen: int, tlen: int, wildcard: int = -1,
                W: Optional[int] = None, S_cap: Optional[int] = None,
                Lp: Optional[int] = None, Lt: Optional[int] = None,
                record_choices: bool = True) -> EngineConfig:
    """Build a no-overflow config for sequences up to (plen, tlen)."""
    pen = attr.penalties
    scope_pad = pen.max_score_scope + 4
    W_full = 2 * max(plen, tlen) + 2 * scope_pad + 8
    if W is None:
        W = W_full
    # W is quantized to multiples of 128: fewer distinct band widths means
    # fewer compiled programs across escalation rungs and batches (each
    # distinct W is a fresh compile). Whether a finer quantum pays on the
    # GPU is an open measurement (ROADMAP)
    W = _round_up(max(W, 32), 128)
    if S_cap is None:
        S_cap = _worst_case_score(pen, plen, tlen) + 2
        S_cap = min(S_cap, attr.system.max_alignment_steps + 2)
    S_cap = max(S_cap, 8)
    h = attr.heuristic
    return EngineConfig(
        metric=pen.distance_metric,
        match=pen.match,
        mismatch=pen.mismatch,
        gap_opening1=pen.gap_opening1,
        gap_extension1=pen.gap_extension1,
        gap_opening2=pen.gap_opening2,
        gap_extension2=pen.gap_extension2,
        span=attr.form.span,
        strategy=int(h.strategy),
        min_wavefront_length=h.min_wavefront_length,
        max_distance_threshold=h.max_distance_threshold,
        steps_between_cutoffs=h.steps_between_cutoffs,
        xdrop=h.xdrop,
        zdrop=h.zdrop,
        band_min_k=h.min_k,
        band_max_k=h.max_k,
        internal_gap_e=pen.internal_gap_e,
        W=W,
        S_cap=S_cap,
        Lp=Lp if Lp is not None else plen,
        Lt=Lt if Lt is not None else tlen,
        record_choices=record_choices,
        wildcard=wildcard,
        match_classes=getattr(attr, "match_classes", ""),
        extend_force=os.environ.get("PYWFA_EXTEND", "").strip().lower(),
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _worst_case_score(pen, plen: int, tlen: int) -> int:
    """Upper bound on the WF score of a complete alignment.

    (reference: wavefront_components.c num_wavefronts computation)
    """
    m = pen.distance_metric
    diff = abs(plen - tlen)
    mn = min(plen, tlen)
    if m in (DistanceMetric.INDEL, DistanceMetric.EDIT):
        return max(plen, tlen) + 1
    if m == DistanceMetric.GAP_LINEAR:
        return mn * pen.mismatch + pen.gap_opening1 * diff + 1
    if m == DistanceMetric.GAP_AFFINE:
        return mn * pen.mismatch + pen.gap_opening1 + diff * pen.gap_extension1 + 1
    i1 = pen.gap_opening1 + diff * pen.gap_extension1
    i2 = pen.gap_opening2 + diff * pen.gap_extension2
    return mn * pen.mismatch + min(i1, i2) + 1


# ===========================================================================
# State
# ===========================================================================

def _init_state(cfg: EngineConfig, B: int, plen, tlen, frees, max_steps):
    """Build the while_loop carry. All arrays int32 unless noted."""
    W, scope, n_comp = cfg.W, cfg.scope, cfg.n_comp
    kmin = cfg.kmin
    karr = jnp.arange(W, dtype=jnp.int32) + kmin  # cell i -> diagonal k

    offsets = jnp.full((n_comp, scope, B, W), NULL, dtype=jnp.int32)
    lo = jnp.ones((n_comp, scope, B), dtype=jnp.int32)
    hi = -jnp.ones((n_comp, scope, B), dtype=jnp.int32)
    m_exists = jnp.zeros((scope, B), dtype=bool)

    # --- WF0 seeding (reference: wavefront_aligner.c:251-310) ---
    seeded = (cfg.span == AlignmentSpan.ENDS_FREE) and cfg.match == 0
    if seeded:
        tbf = frees[:, 2]  # text_begin_free
        pbf = frees[:, 0]  # pattern_begin_free
        wf0_lo = -pbf
        wf0_hi = tbf
        k = karr[None, :]
        # k in [1, tbf] -> offset k; k in [-pbf, -1] -> 0; k == 0 -> 0
        off0 = jnp.where((k >= 0) & (k <= wf0_hi[:, None]),
                         jnp.maximum(k, 0),
                         jnp.where((k < 0) & (k >= wf0_lo[:, None]), 0, NULL))
        overflow = (wf0_lo < kmin + 2) | (wf0_hi > kmin + W - 3)
    else:
        wf0_lo = jnp.zeros((B,), dtype=jnp.int32)
        wf0_hi = jnp.zeros((B,), dtype=jnp.int32)
        off0 = jnp.where(karr[None, :] == 0, 0, NULL)
        off0 = jnp.broadcast_to(off0, (B, W)).astype(jnp.int32)
        overflow = jnp.zeros((B,), dtype=bool)

    offsets = offsets.at[M, 0].set(off0.astype(jnp.int32))
    lo = lo.at[M, 0].set(wf0_lo)
    hi = hi.at[M, 0].set(wf0_hi)
    m_exists = m_exists.at[0].set(True)

    state = dict(
        s=jnp.int32(0),
        seg_base=jnp.int32(0),
        offsets=offsets,
        lo=lo,
        hi=hi,
        m_exists=m_exists,
        done=overflow,
        status=jnp.where(overflow, ST_OVERFLOW_W, ST_RUNNING).astype(jnp.int32),
        final_s=jnp.zeros((B,), dtype=jnp.int32),
        end_k=jnp.zeros((B,), dtype=jnp.int32),
        end_off=jnp.full((B,), NULL, dtype=jnp.int32),
        num_null_steps=jnp.zeros((B,), dtype=jnp.int32),
        # heuristic internals (reference: wavefront_heuristic.c:114-121)
        h_steps_wait=jnp.full((B,), cfg.steps_between_cutoffs, dtype=jnp.int32),
        h_max_sw=jnp.zeros((B,), dtype=jnp.int32),
        h_max_sw_valid=jnp.zeros((B,), dtype=bool),
        h_max_sw_k=jnp.zeros((B,), dtype=jnp.int32),
        h_max_sw_off=jnp.full((B,), NULL, dtype=jnp.int32),
        h_max_wf_score=jnp.zeros((B,), dtype=jnp.int32),
    )
    if cfg.record_choices:
        state["choices"] = jnp.zeros((cfg.S_cap, B, W), dtype=jnp.uint8)
    return state


# ===========================================================================
# Extension
# ===========================================================================

def _extend_band(cfg: EngineConfig, pat, txt, plen, tlen, off, band_mask):
    """Greedy LCP extension of all diagonals, chunked compare.

    pat/txt: [B, L+C] int8, padded with distinct sentinels so runs stop at
    sequence ends without bounds checks (the tensor analog of the reference's
    '!'/'?' EOS padding, wavefront_sequences.c:37-39,64-101).
    off: [B, W] int32; band_mask: [B, W] bool (cells eligible).
    """
    C = cfg.extend_chunk
    W = cfg.W
    karr = jnp.arange(W, dtype=jnp.int32) + cfg.kmin
    cr = jnp.arange(C, dtype=jnp.int32)
    if cfg.match_classes:
        # class-mask matching: chars match iff masks intersect; sentinels
        # and unmapped bytes map to 0 (never match)
        pat, txt = _map_classes(cfg, pat, txt)

    def cond(carry):
        off, active = carry
        return active.any()

    def body(carry):
        off, active = carry
        v = off - karr[None, :]
        h = off
        # clip indices for the gather; invalid cells masked below
        vi = jnp.clip(v, 0, cfg.Lp + C - 1)
        hi_ = jnp.clip(h, 0, cfg.Lt + C - 1)
        pidx = vi[:, :, None] + cr[None, None, :]
        tidx = hi_[:, :, None] + cr[None, None, :]
        pch = jnp.take_along_axis(pat[:, None, :], pidx, axis=2)
        tch = jnp.take_along_axis(txt[:, None, :], tidx, axis=2)
        if cfg.match_classes:
            eq = (pch & tch) != 0
        else:
            eq = pch == tch
            if cfg.wildcard >= 0:
                wc = jnp.int8(cfg.wildcard)
                eq = (eq | (pch == wc) | (tch == wc)) \
                    & (pch != jnp.int8(PATTERN_PAD)) \
                    & (tch != jnp.int8(TEXT_PAD))
        run = jnp.sum(jnp.cumprod(eq.astype(jnp.int32), axis=-1), axis=-1)
        ok = active & (v >= 0) & (h >= 0) & (v < plen[:, None]) & (h < tlen[:, None])
        run = jnp.where(ok, run, 0)
        off = off + run
        active = ok & (run == C)
        return off, active

    active0 = band_mask & (off > NULL_THRESHOLD)
    off, _ = jax.lax.while_loop(cond, body, (off, active0))
    return off


def _map_classes(cfg: EngineConfig, pat, txt):
    """Map token rows through the registered class-mask table.

    Returns int32 mask rows; two cells match iff masks intersect. The
    sentinels (and any byte absent from the table) map to 0, so padded
    tails never match -- the generalized lambda-mode compare
    (reference: wavefront_sequences.c:228-252).
    """
    from ..attributes import match_class_table
    tbl = jnp.asarray(match_class_table(cfg.match_classes)
                      .astype(np.int32))
    to_idx = lambda a: a.astype(jnp.uint8).astype(jnp.int32)
    return tbl[to_idx(pat)], tbl[to_idx(txt)]


def _eq_skew(cfg: EngineConfig, pat, txt, W: Optional[int] = None,
             kmin: Optional[int] = None):
    """Per-diagonal equality eq[b, w, h]: pattern[h - k_w] vs text[h].

    k_w = kmin + w. Built gather-free with the classic skew trick (tiling
    a padded pattern row W times and reshaping shifts each row by one);
    sentinel padding guarantees eq is False past either sequence end.
    W/kmin default to the config's band; passing a sub-range lets callers
    build the band in diagonal chunks (see _build_lcp_table). With
    cfg.match_classes, equality becomes class-mask intersection over the
    mapped rows (same skew, & instead of ==).
    """
    B = pat.shape[0]
    if W is None:
        W = cfg.W
    if kmin is None:
        kmin = cfg.kmin
    Ltp = txt.shape[1]
    Lpp = pat.shape[1]
    classes = bool(cfg.match_classes)
    if classes:
        pat, txt = _map_classes(cfg, pat, txt)
        pad_val = pat.dtype.type(0)
    else:
        pad_val = np.int8(PATTERN_PAD)
    # pattern index for (w, h) is h - k_w + lead; pad so all indices exist:
    # h - k ranges over [-(kmin + W - 1), Ltp - 1 - kmin]
    lead = max(0, kmin + W - 1)
    tail = max(0, Ltp - Lpp - kmin) + 1
    patpad = jnp.pad(pat, ((0, 0), (lead, tail)), constant_values=pad_val)
    N = patpad.shape[1]
    # patk[b, w, h] = patpad[b, c0 + h - w] with c0 = lead - kmin >= W-1
    c0 = lead - kmin
    assert c0 >= W - 1 and c0 + Ltp <= N - 1, (c0, W, Ltp, N)
    tiled = jnp.broadcast_to(patpad[:, None, :], (B, W, N)).reshape(B, W * N)
    skew = tiled[:, : W * (N - 1)].reshape(B, W, N - 1)
    patk = jax.lax.slice_in_dim(skew, c0, c0 + Ltp, axis=2)  # [B, W, Ltp]
    if classes:
        return (patk & txt[:, None, :]) != 0
    eq = patk == txt[:, None, :]
    if cfg.wildcard >= 0:
        # wildcard matches any real character but must NOT match the
        # sentinel padding, or extension would run past sequence ends
        wc = jnp.int8(cfg.wildcard)
        eq = (eq | (patk == wc) | (txt[:, None, :] == wc)) \
            & (patk != jnp.int8(PATTERN_PAD)) \
            & (txt[:, None, :] != jnp.int8(TEXT_PAD))
    return eq


def _build_lcp_table(cfg: EngineConfig, pat, txt):
    """Per-diagonal LCP run-length table R[b, w, h].

    R[b, w, h] = number of consecutive matching characters along diagonal
    k_w = kmin + w starting at text position h (i.e. comparing
    pattern[h-k_w + j] vs text[h + j]). Because both sequences are padded
    with distinct sentinels, runs stop at sequence ends automatically.

    Built once per batch with static shifts and a reverse cummin -- no
    gathers. Extension then reduces to `off += R[b, w, off]` (one gather of
    B*W elements per score step) instead of the chunked compare loop.

    Large bands are built in diagonal chunks: the skew trick's tiled
    intermediate is B x W x ~(W + 2L) elements, which for wide long-read
    bands exceeds 2^31 elements and has silently corrupted under int32
    linearized addressing (observed at W=20096, L=10k: wrong equality ->
    wrong runs -> off-optimal alignments). Chunking by k-range keeps every
    intermediate well under the limit; results are byte-identical.
    """
    Ltp = txt.shape[1]
    B = pat.shape[0]
    dt = jnp.int16 if Ltp < 32000 else jnp.int32
    hidx = jnp.arange(Ltp, dtype=dt)[None, None, :]
    big = dt(Ltp)

    N_est = max(0, cfg.kmin + cfg.W - 1) + pat.shape[1] \
        + max(0, Ltp - pat.shape[1] - cfg.kmin) + 1
    CAP = LCP_BUILD_ELEMS_CAP

    def build_batch(p, t):
        def build(W, kmin):
            eq = _eq_skew(cfg, p, t, W=W, kmin=kmin)
            mism = jnp.where(eq, big, hidx)
            nm = jax.lax.cummin(mism, axis=2, reverse=True)
            return jnp.minimum(nm, big) - hidx

        Bp = p.shape[0]
        if Bp * cfg.W * N_est <= CAP:
            return build(cfg.W, cfg.kmin)
        Wc = max(128, _round_up(CAP // max(1, Bp * N_est), 128))
        chunks = []
        w0 = 0
        while w0 < cfg.W:
            wc = min(Wc, cfg.W - w0)
            chunks.append(build(wc, cfg.kmin + w0))
            w0 += wc
        return jnp.concatenate(chunks, axis=1)

    # extreme short-read/huge-B corner: even a single 128-wide diagonal
    # chunk can exceed the cap, so chunk the batch dimension first
    Bc = max(1, CAP // max(1, N_est * 128))
    if B > Bc:
        run = jnp.concatenate([build_batch(pat[i: i + Bc], txt[i: i + Bc])
                               for i in range(0, B, Bc)], axis=0)
    else:
        run = build_batch(pat, txt)
    if Ltp < 250:
        # short reads: runs fit uint8, halving the per-step lookup stream
        return run.astype(jnp.uint8)
    return run.astype(dt)


EXTEND_MODES = ("bits", "onehot", "onehot4", "table", "chunk")

# default extension by padded text length: packed equality bits up to
# here, the gathered run-length table beyond. `bits` unrolls one word op
# per 32 text positions per step, so its cost and compile time grow with
# Ltp while the gather stays O(B * W). Measured on an H100 (PERF.md):
# bits wins 2x at Ltp 176 (150 bp); table ties it at Ltp 1040 (1 kb) and
# compiles 8x faster. Lengths in between are unmeasured.
BITS_MAX_LTP = 256

# the h-major modes (onehot/onehot4) stream the whole [Ltp, B, W] table
# every step, O(W * Ltp); past this length they are never chosen
HMAJOR_MAX_LTP = 2048


def _extend_mode(cfg: EngineConfig, Ltp: int) -> str:
    """Static choice of the extension formulation.

    Default: `bits` (packed equality bits, find-first-mismatch) for
    Ltp <= BITS_MAX_LTP, else `table` (the W-major run-length table read
    by one gather of B*W elements per step); chunked sequence compares
    when the table is disabled (it would not fit the device, see
    batch.MemCaps). PYWFA_EXTEND forces a mode: bits | onehot | onehot4 |
    table | chunk (captured into cfg.extend_force at config build so each
    mode caches separately); every mode satisfies the same byte contract.
    """
    force = cfg.extend_force
    if force == "chunk" or not cfg.use_lcp_table:
        return "chunk"
    if force in ("onehot", "onehot4") and Ltp > HMAJOR_MAX_LTP:
        return "table"
    if force == "onehot4" and Ltp >= 250:
        return "onehot"  # runs don't fit uint8
    if force in EXTEND_MODES:
        return force
    return "bits" if Ltp <= BITS_MAX_LTP else "table"


def _build_lcp_table_h(cfg: EngineConfig, pat, txt):
    """L-major LCP table R[h, b, w]: the W-major table transposed."""
    return jnp.transpose(_build_lcp_table(cfg, pat, txt), (2, 0, 1))


def _build_lcp_table_h4(cfg: EngineConfig, pat, txt):
    """Packed h-major LCP table: 4 consecutive uint8 run levels per uint32.

    Valid only when runs fit uint8 (Ltp < 250, the headline-bucket case).
    The per-step one-hot stream then visits Ltp/4 levels instead of Ltp
    (same bytes streamed, a quarter of the compare/select/accumulate ops).
    """
    t = _build_lcp_table_h(cfg, pat, txt)  # [Ltp, B, W] uint8
    Ltp = t.shape[0]
    pad = (-Ltp) % 4
    if pad:
        t = jnp.pad(t, ((0, pad), (0, 0), (0, 0)))
    t4 = t.reshape(-1, 4, *t.shape[1:]).astype(jnp.uint32)
    # byte placement by constant multiplies
    return (t4[:, 0] + t4[:, 1] * 256 + t4[:, 2] * 65536
            + t4[:, 3] * 16777216)  # [ceil(Ltp/4), B, W] uint32


def _extend_band_lcp_h4(cfg: EngineConfig, tbl4, tlen, off, band_mask):
    """Extension via the 4-packed h-major LCP table (see builder above)."""
    NH4 = tbl4.shape[0]
    valid = band_mask & (off >= 0) & (off <= tlen[:, None])
    idx = jnp.clip(off, 0, NH4 * 4 - 1)
    it = jnp.int8 if NH4 < 128 else jnp.int16
    hh = (idx >> 2).astype(it)
    byte = idx & 3
    hidx = jnp.arange(NH4, dtype=it)[:, None, None]
    hit = hidx == hh[None]
    sel = jnp.sum(jnp.where(hit, tbl4, jnp.uint32(0)), axis=0,
                  dtype=jnp.uint32)
    run = jnp.where(
        byte == 0, sel & 255,
        jnp.where(byte == 1, (sel >> 8) & 255,
                  jnp.where(byte == 2, (sel >> 16) & 255,
                            sel >> 24))).astype(jnp.int32)
    return jnp.where(valid, off + run, off)


def _extend_band_lcp_h(cfg: EngineConfig, lcp_h, tlen, off, band_mask):
    """Extension via the L-major LCP table: R[h, b, w] at h = off[b, w].

    The lookup streams the table once per step as a one-hot masked
    reduction over the leading (h) axis instead of gathering.
    """
    Ltp = lcp_h.shape[0]
    valid = band_mask & (off >= 0) & (off <= tlen[:, None])
    idx = jnp.clip(off, 0, Ltp - 1)
    it = jnp.int16 if Ltp < 32000 else jnp.int32
    hidx = jnp.arange(Ltp, dtype=it)[:, None, None]
    hit = hidx == idx[None, :, :].astype(it)
    run = jnp.sum(jnp.where(hit, lcp_h, lcp_h.dtype.type(0)), axis=0,
                  dtype=jnp.int32)
    return jnp.where(valid, off + run, off)


def _build_eq_bits(cfg: EngineConfig, pat, txt):
    """Packed per-diagonal equality bits Q[q, b, w], h-major words.

    Bit (h & 31) of Q[h >> 5, b, w] is eq[b, w, h] (same equality as
    _eq_skew, wildcard included); bits past Ltp are 0 (mismatch). One
    uint32 word covers 32 h positions: the per-step extension stream
    drops from Ltp bytes/cell (run-length table) to Ltp/8 bits/cell --
    the batched analog of the reference's 64-bit blockwise compare kernel
    (reference: wavefront_extend_kernels.c:64-88), with the word fetch
    done as a masked stream instead of a random load.
    """
    eq = _eq_skew(cfg, pat, txt)
    B, W, Ltp = eq.shape
    NQ = -(-Ltp // 32)
    padh = NQ * 32 - Ltp
    if padh:
        eq = jnp.pad(eq, ((0, 0), (0, 0), (0, padh)))
    # bit placement by multiply with a constant power-of-two vector
    p2 = (np.uint64(1) << np.arange(32, dtype=np.uint64)).astype(np.uint32)
    w = eq.reshape(B, W, NQ, 32).astype(jnp.uint32) * jnp.asarray(p2)
    words = jnp.sum(w, axis=3, dtype=jnp.uint32)  # distinct bits: sum == or
    return jnp.transpose(words, (2, 0, 1))  # [NQ, B, W]


def _ctz32(m):
    """Count trailing zeros of each uint32 (garbage for m == 0; callers
    mask those lanes).

    Isolate the lowest set bit, convert to float32 (exact: single bit),
    and read the exponent. Bit 31 works too: the sign bit is shifted out
    before the 0xFF mask (0xCF000000 >> 23 & 0xFF = 158 -> 31). This
    stands in for a native count-trailing-zeros (ROADMAP: whether
    lax.population_count / clz pay on the GPU is unmeasured).
    """
    mi = m.astype(jnp.int32)
    lsb = mi & -mi
    f = jax.lax.convert_element_type(lsb, jnp.float32)
    e = (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) & 0xFF
    return e - 127


def _pow2_u32(r):
    """2**r as uint32 for r in [0, 31], via exponent-bit construction.

    Builds the float32 with exponent (r + 127) using constant shifts
    only and converts; stands in for the per-lane variable shift
    `1 << r` (ROADMAP: unmeasured on the GPU).
    """
    f = jax.lax.bitcast_convert_type((r + 127) << 23, jnp.float32)
    return jax.lax.convert_element_type(f, jnp.uint32)


def _extend_band_bits(cfg: EngineConfig, bits, tlen, off, band_mask):
    """Extension via packed equality bits: find-first-mismatch >= off.

    For each cell, the run is (first h >= off with eq bit 0) - off,
    computed by masking the word containing off below bit (off & 31),
    taking a ctz per word, and min-reducing over words. One pass over the
    bit table per step -- 8x less HBM traffic than the run-length
    one-hot and ~10 int ops per word instead of ~3 per h.
    """
    NQ = bits.shape[0]
    big = jnp.int32(NQ * 32)
    valid = band_mask & (off >= 0) & (off <= tlen[:, None])
    idx = jnp.clip(off, 0, NQ * 32 - 1)
    q0 = idx >> 5                               # [B, W]
    r = idx & 31
    full = jnp.uint32(0xFFFFFFFF)
    # word q0's mask (bits >= r): 0xFFFFFFFF << r == -(2^r) mod 2^32,
    # built without a variable shift
    head = jnp.uint32(0) - _pow2_u32(r)
    fm = big
    # static unroll over words: an accumulator chain of [B, W] ops (one
    # fusion streaming the bit table once) instead of [NQ, B, W] temps
    for q in range(NQ):
        sel = jnp.where(q0 == q, head,
                        jnp.where(q0 < q, full, jnp.uint32(0)))
        m = ~bits[q] & sel                      # mismatch bits at h >= idx
        cand = q * 32 + _ctz32(m)
        fm = jnp.minimum(fm, jnp.where(m != 0, cand, big))
    # sentinels guarantee a mismatch before the end of every row, so
    # fm < NQ*32 whenever idx <= tlen; run >= 0 by the mask construction
    return jnp.where(valid, off + (fm - idx), off)


def _extend_band_lcp(cfg: EngineConfig, lcp, tlen, off, band_mask):
    """Extension via the precomputed LCP table: one gather of
    R[b, w, off[b, w]] per step, O(B * W) elements."""
    Ltp = lcp.shape[2]
    valid = band_mask & (off >= 0) & (off <= tlen[:, None])
    idx = jnp.clip(off, 0, Ltp - 1)
    run = jnp.take_along_axis(lcp, idx[:, :, None].astype(jnp.int32),
                              axis=2)[:, :, 0].astype(jnp.int32)
    return jnp.where(valid, off + run, off)


# ===========================================================================
# Packed argmax helper (reference tie priorities)
# ===========================================================================

def _pack(value, prio):
    """(value << 3) | prio; invalid (negative) candidates -> very negative."""
    return jnp.where(value >= 0, (value << 3) | prio, jnp.int32(-2**30))


def _unpack(packed):
    """packed >> 3, restoring exact NULL for all-invalid cells.

    Valid packed values are always >= 0 (offsets are non-negative when
    valid), so `packed < 0` identifies the all-invalid sentinel; mapping
    it to NULL keeps the documented invariant that unreachable offsets
    sit below NULL_THRESHOLD (they'd otherwise unpack to -2^27, which is
    above it)."""
    return jnp.where(packed < 0, NULL, packed >> 3)


# ===========================================================================
# Step function
# ===========================================================================

def _band_mask(cfg, lo, hi):
    """[B, W] mask of cells within [lo, hi]."""
    karr = jnp.arange(cfg.W, dtype=jnp.int32) + cfg.kmin
    return (karr[None, :] >= lo[:, None]) & (karr[None, :] <= hi[:, None])


def _shift(x, dk):
    """x[..., i+dk] viewed at i, NULL-padded (k -> k+dk read)."""
    if dk == 0:
        return x
    W = x.shape[-1]
    pad = jnp.full(x.shape[:-1] + (abs(dk),), NULL, dtype=x.dtype)
    if dk > 0:
        return jnp.concatenate([x[..., dk:], pad], axis=-1)
    return jnp.concatenate([pad, x[..., :dk]], axis=-1)


def _fetch(cfg, state, comp, score):
    """Wavefront (offsets, lo, hi, is_null[B]) for `score` from the ring.

    Ring slots always hold the wavefront of the score they were last
    written for; scope >= max penalty + 1 guarantees no aliasing within
    the live window (reference: wavefront_compute.c:298-344 modular
    fetch). Negative scores need no special-casing: slot (score % scope)
    (non-negative jnp semantics) belongs to score `score + scope`, which
    is > the current score for every penalty lag (all lags < scope), so
    that slot still holds its init state -- NULL offsets, lo=1 > hi=-1,
    m_exists=False -- exactly the null read the reference's NULL check
    produces.
    """
    slot = score % cfg.scope
    off = state["offsets"][comp, slot]
    lo = state["lo"][comp, slot]
    hi = state["hi"][comp, slot]
    if comp == M:
        is_null = (~state["m_exists"][slot]) | (lo > hi)
    else:
        is_null = lo > hi
    return off, lo, hi, is_null


def _compute_limits(parts):
    """Union of non-null input bands, each widened by its role.

    parts: list of (lo, hi, is_null, widen). Returns (lo, hi) [B].
    (reference: wavefront_compute.c:40-86; null inputs' {0} contribution is
    dropped -- post-trim equivalent, see oracle._limits_union)
    """
    big = jnp.int32(2**30)
    los = []
    his = []
    for lo, hi, is_null, widen in parts:
        los.append(jnp.where(is_null, big, lo - widen))
        his.append(jnp.where(is_null, -big, hi + widen))
    lo = functools.reduce(jnp.minimum, los)
    hi = functools.reduce(jnp.maximum, his)
    return lo, hi


def _trim_ends(cfg, off, lo, hi, plen, tlen):
    """Vectorized wavefront_compute_trim_ends (reference: :571-624).

    Returns (new_lo, new_hi). Cells outside the band keep their values; the
    storage invariant (NULL outside band) is enforced by the caller's mask.
    `off` may carry leading stacked axes ([..., B, W]); lo/hi/plen/tlen
    broadcast against them. `any_ok` is derived from `first` (a min over
    the masked iota is < W iff any cell passed) -- one reduction saved.
    """
    W = cfg.W
    iota = jnp.arange(W, dtype=jnp.int32)
    karr = iota + cfg.kmin
    band = (karr >= lo[..., None]) & (karr <= hi[..., None])
    v = off - karr
    h = off
    inb = band & (h >= 0) & (h <= tlen[..., None]) \
        & (v >= 0) & (v <= plen[..., None])
    first = jnp.min(jnp.where(inb, iota, W), axis=-1)
    last = jnp.max(jnp.where(inb, iota, -1), axis=-1) + cfg.kmin
    any_ok = first < W
    new_lo = jnp.where(any_ok, first + cfg.kmin, 1)
    new_hi = jnp.where(any_ok, last, -1)
    return new_lo, new_hi


def _apply_band(off, mask):
    return jnp.where(mask, off, NULL)


def _step_compute(cfg: EngineConfig, state, pat, txt, plen, tlen, frees, active):
    """Compute wavefront for score s+1 (reference: per-metric compute_*.c).

    `active`: [B] pairs still running. Updates ring slot (s+1) % scope.
    Returns (state, overflow[B]).
    """
    s_next = state["s"] + 1
    slot = s_next % cfg.scope
    B, W = state["offsets"].shape[2], cfg.W
    karr = jnp.arange(W, dtype=jnp.int32) + cfg.kmin
    metric = cfg.metric

    if metric in (DistanceMetric.INDEL, DistanceMetric.EDIT):
        return _step_compute_edit(cfg, state, plen, tlen, frees, active)

    x = cfg.mismatch
    o1e1 = cfg.gap_opening1 + cfg.gap_extension1
    e1 = cfg.gap_extension1

    mm_off, mm_lo, mm_hi, mm_null = _fetch(cfg, state, M, s_next - x)
    if metric == DistanceMetric.GAP_LINEAR:
        op_off, op_lo, op_hi, op_null = _fetch(cfg, state, M, s_next - cfg.gap_opening1)
        all_null = mm_null & op_null
        lo_n, hi_n = _compute_limits([
            (mm_lo, mm_hi, mm_null, 0), (op_lo, op_hi, op_null, 1)])
        ins1 = _shift(op_off, -1)
        del1 = _shift(op_off, +1)
        mis = mm_off + 1
        # M = max(del1, max(mis-1, ins1)+1) (reference: compute_linear.c:58-66)
        cand_x = _pack(mis, 5)
        cand_i = _pack(ins1 + 1, 1)
        cand_d = _pack(del1, 3)
        packed = jnp.maximum(cand_d, jnp.maximum(cand_x, cand_i))
        mvals = _unpack(packed)  # all-invalid -> exact NULL
        pr = packed & 7
        msrc = jnp.where(pr == 5, MSRC_X,
                         jnp.where(pr == 3, MSRC_D1,
                                   jnp.where(pr == 1, MSRC_I1, MSRC_NONE)))
        outs = {M: mvals}
        out_null = {M: all_null}
        choice = msrc.astype(jnp.uint8)
    else:
        op1_off, op1_lo, op1_hi, op1_null = _fetch(cfg, state, M, s_next - o1e1)
        i1_off, i1_lo, i1_hi, i1_null = _fetch(cfg, state, I1, s_next - e1)
        d1_off, d1_lo, d1_hi, d1_null = _fetch(cfg, state, D1, s_next - e1)
        parts = [(mm_lo, mm_hi, mm_null, 0), (op1_lo, op1_hi, op1_null, 1),
                 (i1_lo, i1_hi, i1_null, 1), (d1_lo, d1_hi, d1_null, 1)]
        all_null = mm_null & op1_null & i1_null & d1_null

        # I1/D1 with open-vs-ext sub-choice (ext wins ties: prio 1 > 0).
        # All-invalid cells unpack to exact NULL (see _unpack), preserving
        # the below-NULL_THRESHOLD invariant for unreachable offsets; the
        # ext bit is 0 there since the sentinel's low bits are 0.
        i1o = _pack(_shift(op1_off, -1) + 1, 0)
        i1e = _pack(_shift(i1_off, -1) + 1, 1)
        i1p = jnp.maximum(i1o, i1e)
        ins1 = _unpack(i1p)
        i1_ext_bit = (i1p & 7) == 1
        d1o = _pack(_shift(op1_off, +1), 0)
        d1e = _pack(_shift(d1_off, +1), 1)
        d1p = jnp.maximum(d1o, d1e)
        del1 = _unpack(d1p)
        d1_ext_bit = (d1p & 7) == 1
        mis = mm_off + 1

        if metric == DistanceMetric.GAP_AFFINE:
            lo_n, hi_n = _compute_limits(parts)
            # M argmax with global priorities X(5) > D1(3) > I1(1);
            # all-invalid cells give pr == 0 -> MSRC_NONE and a null-ish
            # value (see the I1/D1 comment above)
            pm = jnp.maximum(_pack(mis, 5),
                             jnp.maximum(_pack(del1, 3), _pack(ins1, 1)))
            mvals = _unpack(pm)
            pr = pm & 7
            msrc = jnp.where(pr == 5, MSRC_X,
                             jnp.where(pr == 3, MSRC_D1,
                                       jnp.where(pr == 1, MSRC_I1, MSRC_NONE)))
            outs = {M: mvals, I1: ins1, D1: del1}
            out_null = {M: all_null,
                        I1: op1_null & i1_null,
                        D1: op1_null & d1_null}
            choice = (msrc | (i1_ext_bit << 3) | (d1_ext_bit << 4)).astype(jnp.uint8)
        else:  # GAP_AFFINE_2P
            o2e2 = cfg.gap_opening2 + cfg.gap_extension2
            e2 = cfg.gap_extension2
            op2_off, op2_lo, op2_hi, op2_null = _fetch(cfg, state, M, s_next - o2e2)
            i2_off, i2_lo, i2_hi, i2_null = _fetch(cfg, state, I2, s_next - e2)
            d2_off, d2_lo, d2_hi, d2_null = _fetch(cfg, state, D2, s_next - e2)
            parts += [(op2_lo, op2_hi, op2_null, 1), (i2_lo, i2_hi, i2_null, 1),
                      (d2_lo, d2_hi, d2_null, 1)]
            all_null = all_null & op2_null & i2_null & d2_null
            lo_n, hi_n = _compute_limits(parts)

            i2o = _pack(_shift(op2_off, -1) + 1, 0)
            i2e_ = _pack(_shift(i2_off, -1) + 1, 1)
            i2p = jnp.maximum(i2o, i2e_)
            ins2 = _unpack(i2p)
            i2_ext_bit = (i2p & 7) == 1
            d2o = _pack(_shift(op2_off, +1), 0)
            d2e_ = _pack(_shift(d2_off, +1), 1)
            d2p = jnp.maximum(d2o, d2e_)
            del2 = _unpack(d2p)
            d2_ext_bit = (d2p & 7) == 1
            # global priority X(5) > D2(4) > D1(3) > I2(2) > I1(1);
            # pr == 0 <=> all candidates invalid -> MSRC_NONE
            pm = functools.reduce(jnp.maximum, [
                _pack(mis, 5), _pack(del2, 4), _pack(del1, 3),
                _pack(ins2, 2), _pack(ins1, 1)])
            mvals = _unpack(pm)
            pr = pm & 7
            msrc = jnp.where(pr == 5, MSRC_X,
                             jnp.where(pr == 4, MSRC_D2,
                                       jnp.where(pr == 3, MSRC_D1,
                                                 jnp.where(pr == 2, MSRC_I2,
                                                           jnp.where(pr == 1, MSRC_I1, MSRC_NONE)))))
            outs = {M: mvals, I1: ins1, D1: del1, I2: ins2, D2: del2}
            out_null = {M: all_null,
                        I1: op1_null & i1_null, D1: op1_null & d1_null,
                        I2: op2_null & i2_null, D2: op2_null & d2_null}
            choice = (msrc | (i1_ext_bit << 3) | (d1_ext_bit << 4)
                      | (i2_ext_bit << 5) | (d2_ext_bit << 6)).astype(jnp.uint8)

    # bounds-check M only (reference: compute_affine.c:79-84)
    h = outs[M]
    v = outs[M] - karr[None, :]
    bad = (h < 0) | (h > tlen[:, None]) | (v < 0) | (v > plen[:, None])
    outs[M] = jnp.where(bad, NULL, outs[M])

    # null-step accounting (reference: compute_affine.c:241-247)
    null_step = all_null & active
    state["num_null_steps"] = jnp.where(
        null_step, state["num_null_steps"] + 1,
        jnp.where(active, 0, state["num_null_steps"]))

    # ends-free per-score boundary seeding when match != 0
    # (reference: wavefront_compute.c:124-254)
    seeded_null = jnp.zeros_like(null_step)
    if (cfg.span == AlignmentSpan.ENDS_FREE) and cfg.match != 0:
        outs, lo_n, hi_n, choice, null_step, seeded_null = _endsfree_seed(
            cfg, s_next, outs, lo_n, hi_n, choice, null_step, frees, karr)

    # band overflow check (pre-padding)
    overflow = active & (~null_step) & (
        (lo_n < cfg.kmin + 2) | (hi_n > cfg.kmin + W - 3))
    lo_n = jnp.clip(lo_n, cfg.kmin + 2, cfg.kmin + W - 3)
    hi_n = jnp.clip(hi_n, cfg.kmin + 2, cfg.kmin + W - 3)

    # write outputs: only active, non-null-step pairs produce wavefronts.
    # All components are stacked on a leading axis so the trim reductions
    # and the ring update run once per step instead of once per component.
    write = active & (~null_step)
    band = _band_mask(cfg, lo_n, hi_n) & write[:, None]

    comps = sorted(outs)  # M(0), I1(1), D1(2)[, I2(3), D2(4)] -- ring order
    assert comps == list(range(len(comps)))
    vals3 = jnp.stack([outs[c] for c in comps])  # [nc, B, W]
    # M is always materialized on a non-null step
    # (reference: wavefront_compute.c:438-443)
    prod3 = jnp.stack([write if c == M else write & (~out_null[c])
                       for c in comps])          # [nc, B]
    arr3 = jnp.where(band[None] & prod3[:, :, None], vals3, NULL)
    # trim ends (reference: wavefront_compute.c:571-624); the null-step
    # seeding path performs no trim (no process_ends there)
    tlo3, thi3 = _trim_ends(cfg, arr3, jnp.broadcast_to(lo_n, prod3.shape),
                            jnp.broadcast_to(hi_n, prod3.shape), plen, tlen)
    if cfg.span == AlignmentSpan.ENDS_FREE and cfg.match != 0:
        tlo3 = tlo3.at[M].set(jnp.where(seeded_null, lo_n, tlo3[M]))
        thi3 = thi3.at[M].set(jnp.where(seeded_null, hi_n, thi3[M]))
    tlo3 = jnp.where(prod3, tlo3, 1)
    thi3 = jnp.where(prod3, thi3, -1)
    karr_w = jnp.arange(cfg.W, dtype=jnp.int32) + cfg.kmin
    band3 = (karr_w >= tlo3[..., None]) & (karr_w <= thi3[..., None])
    arr3 = jnp.where(band3, arr3, NULL)

    state["offsets"] = jax.lax.dynamic_update_slice(
        state["offsets"], arr3[:, None], (0, slot, 0, 0))
    state["lo"] = jax.lax.dynamic_update_slice(
        state["lo"], tlo3[:, None], (0, slot, 0))
    state["hi"] = jax.lax.dynamic_update_slice(
        state["hi"], thi3[:, None], (0, slot, 0))
    state["m_exists"] = state["m_exists"].at[slot].set(write)

    if cfg.record_choices:
        # record over the pre-trim band: I/D sub-choice bits are needed
        # wherever I/D cells are valid, which can exceed M's trimmed band
        ch = jnp.where(band, choice, 0).astype(jnp.uint8)
        state["choices"] = jax.lax.dynamic_update_index_in_dim(
            state["choices"], ch, s_next - state["seg_base"], axis=0)
    return state, overflow


def _endsfree_seed(cfg, s_next, outs, lo_n, hi_n, choice, null_step, frees, karr):
    """Ends-free boundary seeding for match != 0 (reference: compute.c:124-254).

    NOTE: the reference allocates an M wavefront on EVERY match-multiple
    score while any begin-free slack is configured, even when ek exceeds the
    frees and no seed is written (wavefront_compute_endsfree_required does
    not compare ek to the frees; endsfree_allocate_null then produces an
    empty [0,0]-band wavefront). That phantom wavefront keeps the heuristic
    cadence ticking, so it must be materialized here too.
    Returns (outs, lo_n, hi_n, choice, null_step, seeded_null) where
    seeded_null marks pairs whose wavefront came from the null-step
    allocation path (no end-trim in the reference).
    """
    mvals = outs[M]
    need = (s_next % (-cfg.match)) == 0
    if not isinstance(need, jnp.ndarray):
        need = jnp.array(need)
    # per-pair: any begin-free slack configured at all
    need = need & ((frees[:, 0] > 0) | (frees[:, 2] > 0))
    ek = s_next // (-cfg.match)
    tb = frees[:, 2] >= ek
    pb = frees[:, 0] >= ek
    kcell = karr[None, :]
    at_pk = kcell == ek
    at_nk = kcell == -ek
    seed_t = need & tb
    seed_p = need & pb
    do_t = seed_t[:, None] & at_pk & (mvals <= ek)
    do_p = seed_p[:, None] & at_nk & (mvals <= 0)
    mvals = jnp.where(do_t, ek, mvals)
    mvals = jnp.where(do_p, 0, mvals)
    choice = jnp.where(do_t | do_p, jnp.uint8(MSRC_SEED), choice)
    # band on the null-step allocation path
    # (reference: wavefront_compute_endsfree_allocate_null)
    ns_lo = jnp.where(seed_p, -ek, jnp.where(seed_t, ek, 0))
    ns_hi = jnp.where(seed_t, ek, jnp.where(seed_p, -ek, 0))
    # band widening on the regular compute path
    lo_n = jnp.where(seed_p, jnp.minimum(lo_n, -ek), lo_n)
    hi_n = jnp.where(seed_t, jnp.maximum(hi_n, ek), hi_n)
    lo_n = jnp.where(null_step & need, ns_lo, lo_n)
    hi_n = jnp.where(null_step & need, ns_hi, hi_n)
    outs[M] = mvals
    seeded_null = null_step & need
    null_step = null_step & ~need
    return outs, lo_n, hi_n, choice, null_step, seeded_null


def _step_compute_edit(cfg, state, plen, tlen, frees, active):
    """Edit/indel compute (reference: wavefront_compute_edit.c:330-374)."""
    s_next = state["s"] + 1
    slot = s_next % cfg.scope
    W = cfg.W
    karr = jnp.arange(W, dtype=jnp.int32) + cfg.kmin
    p_off, p_lo, p_hi, p_null = _fetch(cfg, state, M, s_next - 1)
    lo_n = p_lo - 1
    hi_n = p_hi + 1
    ins_src = _shift(p_off, -1)
    del_src = _shift(p_off, +1)
    if cfg.metric == DistanceMetric.INDEL:
        cand_i = _pack(ins_src + 1, 1)
        cand_d = _pack(del_src, 3)
        pm = jnp.maximum(cand_i, cand_d)
        mvals = pm >> 3  # all-invalid -> null-ish (see _step_compute)
        pr = pm & 7
        msrc = jnp.where(pr == 3, MSRC_D1,
                         jnp.where(pr == 1, MSRC_I1, MSRC_NONE))
    else:
        cand_x = _pack(p_off + 1, 5)
        cand_i = _pack(ins_src + 1, 1)
        cand_d = _pack(del_src, 3)
        pm = functools.reduce(jnp.maximum, [cand_x, cand_d, cand_i])
        mvals = pm >> 3
        pr = pm & 7
        msrc = jnp.where(pr == 5, MSRC_X,
                         jnp.where(pr == 3, MSRC_D1,
                                   jnp.where(pr == 1, MSRC_I1, MSRC_NONE)))
    h = mvals
    v = mvals - karr[None, :]
    bad = (h < 0) | (h > tlen[:, None]) | (v < 0) | (v > plen[:, None])
    mvals = jnp.where(bad, NULL, mvals)

    overflow = active & ((lo_n < cfg.kmin + 2) | (hi_n > cfg.kmin + W - 3))
    lo_n = jnp.clip(lo_n, cfg.kmin + 2, cfg.kmin + W - 3)
    hi_n = jnp.clip(hi_n, cfg.kmin + 2, cfg.kmin + W - 3)

    band = _band_mask(cfg, lo_n, hi_n) & active[:, None]
    arr = jnp.where(band, mvals, NULL)
    tlo, thi = _trim_ends(cfg, arr, lo_n, hi_n, plen, tlen)
    tlo = jnp.where(active, tlo, 1)
    thi = jnp.where(active, thi, -1)
    arr = _apply_band(arr, _band_mask(cfg, tlo, thi))
    state["offsets"] = state["offsets"].at[M, slot].set(arr)
    state["lo"] = state["lo"].at[M, slot].set(tlo)
    state["hi"] = state["hi"].at[M, slot].set(thi)
    state["m_exists"] = state["m_exists"].at[slot].set(active)
    # curr null -> effectively unreachable (reference: compute_edit.c:366)
    state["num_null_steps"] = jnp.where(active & (tlo > thi),
                                        jnp.int32(2**30),
                                        state["num_null_steps"])
    if cfg.record_choices:
        ch = jnp.where(band, msrc, 0).astype(jnp.uint8)
        state["choices"] = jax.lax.dynamic_update_index_in_dim(
            state["choices"], ch, s_next - state["seg_base"], axis=0)
    return state, overflow


# ===========================================================================
# Termination
# ===========================================================================

def _terminate_end2end(cfg, off, lo, hi, exists, plen, tlen):
    """(reference: wavefront_termination.c:37-114, component_end = M)

    The target-diagonal read is a one-hot masked reduction over the
    [B, W] band rather than a gather.
    """
    ak = tlen - plen
    karr = jnp.arange(cfg.W, dtype=jnp.int32) + cfg.kmin
    cell = jnp.max(jnp.where(karr == ak[:, None], off, NULL), axis=1)
    hit = exists & (lo <= ak) & (ak <= hi) & (cell >= tlen)
    return hit, ak, tlen


def _terminate_endsfree(cfg, off, lo, hi, exists, plen, tlen, frees):
    """(reference: wavefront_termination.c:115-162; lowest-k hit wins)"""
    W = cfg.W
    karr = jnp.arange(W, dtype=jnp.int32) + cfg.kmin
    band = _band_mask(cfg, lo, hi)
    valid = band & (off > NULL_THRESHOLD)
    v = off - karr[None, :]
    h = off
    pef = frees[:, 1][:, None]
    tef = frees[:, 3][:, None]
    done_h = valid & (h >= tlen[:, None]) & ((plen[:, None] - v) <= pef)
    done_v = valid & (v >= plen[:, None]) & ((tlen[:, None] - h) <= tef)
    done = done_h | done_v
    iota = jnp.arange(W, dtype=jnp.int32)
    first = jnp.min(jnp.where(done, iota, W), axis=1)
    hit = exists & (first < W)
    firstc = jnp.minimum(first, W - 1)
    kk = firstc + cfg.kmin
    end_off = jnp.max(jnp.where(iota == firstc[:, None], off, NULL), axis=1)
    return hit, kk, end_off


# ===========================================================================
# Heuristics (reference: wavefront_heuristic.c:509-567 cascade)
# ===========================================================================

def _heuristic_cutoff(cfg: EngineConfig, state, plen, tlen, frees, active):
    """Apply the heuristic cascade to M[s]; returns (state, zdropped[B])."""
    strat = cfg.strategy
    B = plen.shape[0]
    if strat == 0:
        return state, jnp.zeros((B,), dtype=bool)
    s = state["s"]
    slot = s % cfg.scope
    off = state["offsets"][M, slot]
    lo = state["lo"][M, slot]
    hi = state["hi"][M, slot]
    exists = state["m_exists"][slot]
    eligible = active & exists & (lo <= hi)

    state["h_steps_wait"] = jnp.where(eligible, state["h_steps_wait"] - 1,
                                      state["h_steps_wait"])
    ready = eligible & (state["h_steps_wait"] <= 0)
    lo_base, hi_base = lo, hi
    karr = jnp.arange(cfg.W, dtype=jnp.int32) + cfg.kmin
    zdropped = jnp.zeros((B,), dtype=bool)
    acted = jnp.zeros((B,), dtype=bool)

    if strat & (HeuristicStrategy.WFADAPTIVE | HeuristicStrategy.WFMASH):
        wfmash = bool(strat & HeuristicStrategy.WFMASH)
        do = ready & ((hi - lo + 1) >= cfg.min_wavefront_length)
        band = _band_mask(cfg, lo, hi)
        v = off - karr[None, :]
        h = off
        if wfmash:
            mfactor = ((plen + tlen).astype(jnp.float32) / 2)
            lv = ((plen[:, None] - v).astype(jnp.float32)
                  / plen[:, None].astype(jnp.float32) * mfactor[:, None]).astype(jnp.int32)
            lh = ((tlen[:, None] - h).astype(jnp.float32)
                  / tlen[:, None].astype(jnp.float32) * mfactor[:, None]).astype(jnp.int32)
            dist = jnp.maximum(lv, lh)
        else:
            dist = jnp.maximum(plen[:, None] - v, tlen[:, None] - h)
        dist = jnp.where(off >= 0, dist, -jnp.int32(OFFSET_NULL))
        big = jnp.int32(2**30)
        mind = jnp.min(jnp.where(band, dist,
                                 jnp.maximum(plen, tlen)[:, None]), axis=1)
        keep = (dist - mind[:, None]) <= cfg.max_distance_threshold
        ak = tlen - plen
        # reduce from bottom over [lo, min(ak, hi)) (reference: :236-248)
        top_limit = jnp.minimum(ak, hi)
        iota = jnp.arange(cfg.W, dtype=jnp.int32)[None, :]
        in_bot = band & (karr[None, :] < top_limit[:, None])
        stop_bot = in_bot & keep
        any_bot = stop_bot.any(axis=1)
        first_keep = jnp.min(jnp.where(stop_bot, iota, cfg.W),
                             axis=1) + cfg.kmin
        lo_red = jnp.where(any_bot, first_keep, jnp.maximum(top_limit, lo))
        new_lo = jnp.where(do, jnp.maximum(lo_red, lo), lo)
        # reduce from top over (max(ak, new_lo), hi]
        bot_limit = jnp.maximum(ak, new_lo)
        in_top = band & (karr[None, :] > bot_limit[:, None])
        stop_top = in_top & keep
        any_top = stop_top.any(axis=1)
        last_keep = jnp.max(jnp.where(stop_top, iota, -1), axis=1) + cfg.kmin
        hi_red = jnp.where(any_top, last_keep, jnp.minimum(bot_limit, hi))
        new_hi = jnp.where(do, jnp.minimum(hi_red, hi), hi)
        lo, hi = new_lo, new_hi
        acted = acted | do
        state["h_steps_wait"] = jnp.where(do, cfg.steps_between_cutoffs,
                                          state["h_steps_wait"])

    if strat & (HeuristicStrategy.XDROP | HeuristicStrategy.ZDROP):
        # each sub-heuristic re-checks steps_wait at entry, so a reset by
        # wf-adaptive above skips the drop check this step
        # (reference: wavefront_heuristic.c:271,345 entry guards)
        do = eligible & (state["h_steps_wait"] <= 0)
        band = _band_mask(cfg, lo, hi)
        swg_match = -cfg.match if cfg.match != 0 else 1
        v = off - karr[None, :]
        h = off
        # trunc division by 2 (C semantics); operands can be negative
        num = swg_match * (v + h) - s
        sw = jnp.where(num >= 0, num // 2, -((-num) // 2))
        valid = band & (off >= 0)
        neg_big = jnp.int32(-2**30)
        swm = jnp.where(valid, sw, neg_big)
        cmax = jnp.max(swm, axis=1)
        cidx = jnp.argmax(swm, axis=1).astype(jnp.int32)
        cmax_k = cidx + cfg.kmin
        cmax_off = jnp.take_along_axis(off, cidx[:, None], axis=1)[:, 0]
        have_hist = state["h_max_sw_valid"]
        if strat & HeuristicStrategy.XDROP:
            prune = do & have_hist
            keep = valid & ((state["h_max_sw"][:, None] - sw) < cfg.xdrop)
            any_keep = keep.any(axis=1)
            iota_x = jnp.arange(cfg.W, dtype=jnp.int32)[None, :]
            first = jnp.min(jnp.where(keep, iota_x, cfg.W), axis=1) + cfg.kmin
            last = jnp.max(jnp.where(keep, iota_x, -1), axis=1) + cfg.kmin
            lo = jnp.where(prune, jnp.where(any_keep, first, hi + 1), lo)
            hi = jnp.where(prune, jnp.where(any_keep, last, lo - 1), hi)
            upd = do & ((~have_hist) | (cmax > state["h_max_sw"]))
            state["h_max_sw"] = jnp.where(upd, cmax, state["h_max_sw"])
            state["h_max_sw_k"] = jnp.where(upd, cmax_k, state["h_max_sw_k"])
            state["h_max_sw_valid"] = state["h_max_sw_valid"] | do
            acted = acted | do
            state["h_steps_wait"] = jnp.where(do, cfg.steps_between_cutoffs,
                                              state["h_steps_wait"])
        else:  # ZDROP
            improved = cmax > state["h_max_sw"]
            zdropped = do & have_hist & (~improved) & (
                (state["h_max_sw"] - cmax) > cfg.zdrop)
            upd = do & ((~have_hist) | improved)
            state["h_max_sw"] = jnp.where(upd, cmax, state["h_max_sw"])
            state["h_max_wf_score"] = jnp.where(upd, s, state["h_max_wf_score"])
            state["h_max_sw_k"] = jnp.where(upd, cmax_k, state["h_max_sw_k"])
            state["h_max_sw_off"] = jnp.where(upd, cmax_off, state["h_max_sw_off"])
            state["h_max_sw_valid"] = state["h_max_sw_valid"] | do
            acted = acted | (do & ~zdropped)
            state["h_steps_wait"] = jnp.where(do & ~zdropped,
                                              cfg.steps_between_cutoffs,
                                              state["h_steps_wait"])

    if strat & HeuristicStrategy.BANDED_STATIC:
        lo = jnp.where(eligible, jnp.maximum(lo, cfg.band_min_k), lo)
        hi = jnp.where(eligible, jnp.minimum(hi, cfg.band_max_k), hi)
    elif strat & HeuristicStrategy.BANDED_ADAPTIVE:
        wf_len = hi - lo + 1
        max_len = cfg.band_max_k - cfg.band_min_k + 1
        # C resets steps_wait whenever wf_length >= 4, even when the band
        # needs no adjustment (reference: wavefront_heuristic.c:472-505);
        # steps_wait re-checked at entry (resets by earlier cascade stages
        # skip this stage for the step)
        ticked = eligible & (state["h_steps_wait"] <= 0) & (wf_len >= 4)
        do = ticked & (wf_len > max_len)

        def dist_at(kq):
            idx = jnp.clip(kq - cfg.kmin, 0, cfg.W - 1)
            o = jnp.take_along_axis(off, idx[:, None], axis=1)[:, 0]
            d = jnp.maximum(plen - (o - kq), tlen - o)
            return jnp.where(o >= 0, d, -jnp.int32(OFFSET_NULL))

        leeway = (wf_len - max_len) // 2
        quarter = wf_len // 4
        d0 = dist_at(lo)
        d1 = dist_at(lo + quarter)
        d2 = dist_at(lo + 2 * quarter)
        d3 = dist_at(hi)
        new_lo0 = lo + jnp.where(d0 > d3, leeway, 0) + jnp.where(d1 > d2, leeway, 0)
        nlo = jnp.maximum(new_lo0, lo)
        nhi = jnp.minimum(new_lo0 + max_len - 1, hi)
        lo = jnp.where(do, nlo, lo)
        hi = jnp.where(do, nhi, hi)
        acted = acted | do
        state["h_steps_wait"] = jnp.where(ticked, cfg.steps_between_cutoffs,
                                          state["h_steps_wait"])

    changed = eligible & ((lo != lo_base) | (hi != hi_base))
    # install pruned M band + re-establish NULL-outside invariant
    new_band = _band_mask(cfg, lo, hi)
    off2 = jnp.where(changed[:, None], _apply_band(off, new_band), off)
    state["offsets"] = state["offsets"].at[M, slot].set(off2)
    state["lo"] = state["lo"].at[M, slot].set(jnp.where(changed, lo, lo_base))
    state["hi"] = state["hi"].at[M, slot].set(jnp.where(changed, hi, hi_base))
    # equate I/D to M's band (reference: :554-565)
    if cfg.n_comp > 1:
        for comp in range(1, cfg.n_comp):
            clo = state["lo"][comp, slot]
            chi = state["hi"][comp, slot]
            nlo = jnp.where(changed, jnp.maximum(clo, lo), clo)
            nhi = jnp.where(changed, jnp.minimum(chi, hi), chi)
            coff = state["offsets"][comp, slot]
            coff = jnp.where(changed[:, None],
                             _apply_band(coff, _band_mask(cfg, nlo, nhi)), coff)
            state["offsets"] = state["offsets"].at[comp, slot].set(coff)
            state["lo"] = state["lo"].at[comp, slot].set(nlo)
            state["hi"] = state["hi"].at[comp, slot].set(nhi)
    return state, zdropped


# ===========================================================================
# Main loop
# ===========================================================================

def memory_estimate(cfg: EngineConfig, B: int) -> dict:
    """Device-memory footprint of one engine invocation, in bytes.

    Analog of wavefront_aligner_get_size (reference:
    wavefront_aligner.c:646-662) for capacity planning.
    """
    W, scope, n_comp = cfg.W, cfg.scope, cfg.n_comp
    ring = n_comp * scope * B * W * 4
    lohi = n_comp * scope * B * 4 * 2
    choices = cfg.S_cap * B * W if cfg.record_choices else 0
    Ltp = cfg.Lt + cfg.extend_chunk
    dt = 2 if Ltp < 32000 else 4
    lcp = B * W * Ltp * dt if cfg.use_lcp_table else 0
    seqs = B * (cfg.Lp + cfg.Lt + 2 * cfg.extend_chunk)
    total = ring + lohi + choices + lcp + seqs
    return dict(ring=ring, lohi=lohi, choices=choices, lcp_table=lcp,
                sequences=seqs, total=total)


def _run_loop(cfg: EngineConfig, state, pat, txt, plen, tlen, frees,
              max_steps):
    """Run the score loop from `state` for up to S_cap-1 more steps."""
    end2end = cfg.span == AlignmentSpan.END_TO_END
    mode = _extend_mode(cfg, txt.shape[1])
    if mode == "bits":
        lcp = _build_eq_bits(cfg, pat, txt)
    elif mode == "onehot4":
        lcp = _build_lcp_table_h4(cfg, pat, txt)
    elif mode == "onehot":
        lcp = _build_lcp_table_h(cfg, pat, txt)
    elif mode == "table":
        lcp = _build_lcp_table(cfg, pat, txt)
    else:
        lcp = None
    seg_end = state["seg_base"] + (cfg.S_cap - 1)

    def cond(state):
        return (~state["done"]).any() & (state["s"] < seg_end)

    def body(state):
        s = state["s"]
        slot = s % cfg.scope
        active = ~state["done"]
        off = state["offsets"][M, slot]
        lo = state["lo"][M, slot]
        hi = state["hi"][M, slot]
        exists = state["m_exists"][slot]

        # --- null-pointer feasibility (reference: extend.c:100-106) ---
        dead = active & (~exists) & (
            state["num_null_steps"] > cfg.scope)
        state["done"] = state["done"] | dead
        state["status"] = jnp.where(dead, ST_END_UNREACHABLE, state["status"])
        state["final_s"] = jnp.where(dead, s, state["final_s"])
        active = active & ~dead

        # --- extension (only pairs with an existing M wavefront) ---
        # No band mask needed: the storage invariant keeps cells outside
        # [lo, hi] at NULL (< 0), so the extension's own off >= 0 guard
        # already excludes them. [B, 1] broadcasts against [B, W] inside.
        band = (active & exists)[:, None]
        if mode == "bits":
            off = _extend_band_bits(cfg, lcp, tlen, off, band)
        elif mode == "onehot4":
            off = _extend_band_lcp_h4(cfg, lcp, tlen, off, band)
        elif mode == "onehot":
            off = _extend_band_lcp_h(cfg, lcp, tlen, off, band)
        elif mode == "table":
            off = _extend_band_lcp(cfg, lcp, tlen, off, band)
        else:
            off = _extend_band(cfg, pat, txt, plen, tlen, off, band)
        state["offsets"] = state["offsets"].at[M, slot].set(off)

        # --- termination ---
        if end2end:
            hit, kk, eoff = _terminate_end2end(cfg, off, lo, hi, exists, plen, tlen)
        else:
            hit, kk, eoff = _terminate_endsfree(cfg, off, lo, hi, exists,
                                                plen, tlen, frees)
        hit = hit & active
        state["done"] = state["done"] | hit
        state["status"] = jnp.where(hit, ST_END_REACHED, state["status"])
        state["final_s"] = jnp.where(hit, s, state["final_s"])
        state["end_k"] = jnp.where(hit, kk, state["end_k"])
        state["end_off"] = jnp.where(hit, eoff, state["end_off"])
        active = active & ~hit

        # --- heuristics ---
        state, zdropped = _heuristic_cutoff(cfg, state, plen, tlen, frees,
                                            active & exists)
        state["done"] = state["done"] | zdropped
        state["status"] = jnp.where(zdropped, ST_END_UNREACHABLE, state["status"])
        state["final_s"] = jnp.where(zdropped, s, state["final_s"])
        # z-drop records the historical max position as the end position
        state["end_k"] = jnp.where(zdropped, state["h_max_sw_k"], state["end_k"])
        state["end_off"] = jnp.where(zdropped, state["h_max_sw_off"],
                                     state["end_off"])
        active = active & ~zdropped

        # --- compute s+1 ---
        state, overflow = _step_compute(cfg, state, pat, txt, plen, tlen,
                                        frees, active)
        state["done"] = state["done"] | overflow
        state["status"] = jnp.where(overflow, ST_OVERFLOW_W, state["status"])
        active = active & ~overflow

        # --- max-steps probe (reference: unialign.c:100-107) ---
        s_next = s + 1
        hit_max = active & (s_next >= max_steps)
        state["done"] = state["done"] | hit_max
        state["status"] = jnp.where(hit_max, ST_MAX_STEPS, state["status"])
        state["final_s"] = jnp.where(hit_max, s_next, state["final_s"])

        state["s"] = s_next
        return state

    return jax.lax.while_loop(cond, body, state)


def _finish(cfg, state):
    running = ~state["done"]
    out = dict(
        status=jnp.where(running, ST_OVERFLOW_S, state["status"]),
        final_s=jnp.where(running, state["s"], state["final_s"]),
        end_k=state["end_k"],
        end_off=state["end_off"],
        steps=state["s"],
    )
    if cfg.record_choices:
        out["choices"] = state["choices"]
    return out


def _align_core(cfg: EngineConfig, pat, txt, plen, tlen, frees, max_steps):
    """init -> score loop -> finish: the one engine body every jitted
    align_batch_* variant wraps (input decode on the way in, output
    packing on the way out)."""
    B = pat.shape[0]
    state = _init_state(cfg, B, plen, tlen, frees, max_steps)
    state = _run_loop(cfg, state, pat, txt, plen, tlen, frees, max_steps)
    return _finish(cfg, state)


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch(cfg: EngineConfig, pat, txt, plen, tlen, frees, max_steps):
    """Batched WFA over B pairs.

    pat: [B, Lp + C] int8 (sentinel-padded), txt: [B, Lt + C] int8,
    plen/tlen: [B] int32, frees: [B, 4] int32
    (pattern_begin, pattern_end, text_begin, text_end), max_steps: [] int32.

    Returns dict with per-pair status/final_s/end_k/end_off (+ choices).
    Pairs still running at S_cap report ST_OVERFLOW_S (escalate or segment).
    """
    return _align_core(cfg, pat, txt, plen, tlen, frees, max_steps)


def fused_widths(cfg) -> Tuple[int, int]:
    """Token-row widths (pattern, text) of the fused input layout."""
    return cfg.Lp + cfg.extend_chunk, cfg.Lt + cfg.extend_chunk


def packed_widths(cfg) -> Tuple[int, int]:
    """Byte-row widths (pattern, text) of the 2-bit-packed input layout.

    Only the [0, Lp)/[0, Lt) base region is pushed: every position past a
    pair's length decodes to the sentinel anyway (_decode_packed masks on
    the length), so the extend_chunk tail would be dead wire bytes --
    ~30% of the push at the 150bp shape.
    """
    return -(-cfg.Lp // 4), -(-cfg.Lt // 4)


def _decode_fused(cfg, fused):
    """Split one [B, Wp+Wt] fused token array into (pat, txt) rows."""
    wp, _ = fused_widths(cfg)
    return fused[:, :wp], fused[:, wp:]


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch_fused(cfg: EngineConfig, fused, plen, tlen, frees, max_steps):
    """align_batch with pattern|text token rows in ONE [B, Wp+Wt] array
    (one host->device transfer; the slice is free inside the compiled
    graph)."""
    pat, txt = _decode_fused(cfg, fused)
    return _align_core(cfg, pat, txt, plen, tlen, frees, max_steps)


def _decode_packed(cfg, packed, plen, tlen):
    """[B, Pp+Pt] uint8 2-bit DNA -> the exact int8 token rows encode_batch
    would produce (ACGT bytes up to each length, sentinel past it).

    Device-side analog of the reference's packed-2-bits decode
    (reference: wavefront_sequences.c:102-140); the sentinel re-padding
    replaces its EOS trick since lengths are explicit here.
    """
    pp, _ = packed_widths(cfg)
    wp, wt = fused_widths(cfg)

    def dec(block, width, length, pad):
        B = block.shape[0]
        b32 = block.astype(jnp.int32)[:, :, None]
        codes = (b32 >> (2 * jnp.arange(4, dtype=jnp.int32))) & 3
        codes = codes.reshape(B, -1)
        if codes.shape[1] < width:
            # pushed bytes cover only the base region (packed_widths);
            # the extend_chunk tail is always past every length and the
            # mask below sentinel-fills it, so pad with anything
            codes = jnp.pad(codes, ((0, 0), (0, width - codes.shape[1])))
        else:
            codes = codes[:, :width]
        # arithmetic 4-way select instead of a table gather
        tok = jnp.where(
            codes == 0, ord("A"),
            jnp.where(codes == 1, ord("C"),
                      jnp.where(codes == 2, ord("G"), ord("T"))),
        ).astype(jnp.int8)
        iota = jnp.arange(width, dtype=jnp.int32)[None, :]
        return jnp.where(iota < length[:, None], tok, jnp.int8(pad))

    pat = dec(packed[:, :pp], wp, plen, PATTERN_PAD)
    txt = dec(packed[:, pp:], wt, tlen, TEXT_PAD)
    return pat, txt


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch_packed(cfg: EngineConfig, packed, plen, tlen, frees,
                       max_steps):
    """align_batch from fused 2-bit-packed DNA rows (4x smaller push)."""
    plen = plen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    pat, txt = _decode_packed(cfg, packed, plen, tlen)
    return _align_core(cfg, pat, txt, plen, tlen, frees, max_steps)


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch_start(cfg: EngineConfig, pat, txt, plen, tlen, frees,
                      max_steps):
    """Segmented execution, first segment: returns (out, resumable state).

    Device memory is bounded by one segment's choices block [S_cap, B, W];
    the host collects per-segment choice blocks and stitches the traceback
    (see traceback_walk_segment). This is the engine's checkpoint/resume
    primitive -- the analog of both the reference's low-memory modes
    (bounded traceback storage, wavefront_backtrace_offload.c) and its
    experimental wavefront_align_resume (wavefront_align.c:245-266).
    """
    B = pat.shape[0]
    state = _init_state(cfg, B, plen, tlen, frees, max_steps)
    state = _run_loop(cfg, state, pat, txt, plen, tlen, frees, max_steps)
    return _finish(cfg, state), state


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch_resume(cfg: EngineConfig, pat, txt, plen, tlen, frees,
                       max_steps, state):
    """Continue a segmented run from `state` for another S_cap-1 steps."""
    state = dict(state)
    state["seg_base"] = state["s"]
    if cfg.record_choices:
        state["choices"] = jnp.zeros_like(state["choices"])
    state = _run_loop(cfg, state, pat, txt, plen, tlen, frees, max_steps)
    return _finish(cfg, state), state


def unpause_max_steps(state):
    """Un-pause pairs stopped at ST_MAX_STEPS so a subsequent
    align_batch_resume with a RAISED max_steps continues them from their
    retained wavefront ring -- the engine half of the reference's
    experimental resume (reference: wavefront_align.c:245-266: a
    MAX_STEPS-paused unidirectional alignment retains all state and
    continues after max_steps is raised). Pairs paused at s == old
    max_steps resume with the extension of that same score, exactly where
    the loop left off."""
    state = dict(state)
    paused = state["status"] == ST_MAX_STEPS
    state["status"] = jnp.where(paused, ST_RUNNING, state["status"])
    state["done"] = state["done"] & ~paused
    return state


# ===========================================================================
# Traceback walk (choices tensor -> op stream)
# ===========================================================================

def _walk_step_fn(cfg: EngineConfig, B: int):
    """Per-level walk step (shared by one-shot and segmented walks).

    Rather than gathering choices[s[b], b, k[b]] per step, the scan runs
    over *score levels* from high to low with the choices tensor as its
    streamed input: a pair acts only at its current score (scores strictly
    decrease per op), and the cell read becomes a one-hot select over the W
    lanes of the level's slice -- no gathers at all.

    The M-preceded flag marks ops selected while in the M matrix -- exactly
    the positions where the reference's backtrace inserts a match run
    (reference: wavefront_backtrace.c:425-436).
    """
    x = cfg.mismatch
    o1e1 = cfg.gap_opening1 + cfg.gap_extension1
    e1 = cfg.gap_extension1
    o2e2 = cfg.gap_opening2 + cfg.gap_extension2
    e2 = cfg.gap_extension2
    is_linear = cfg.metric in (DistanceMetric.INDEL, DistanceMetric.EDIT,
                               DistanceMetric.GAP_LINEAR)
    if cfg.metric in (DistanceMetric.INDEL, DistanceMetric.EDIT):
        lin_open = 1
        lin_x = 1
    else:
        lin_open = cfg.gap_opening1
        lin_x = cfg.mismatch

    karr = jnp.arange(cfg.W, dtype=jnp.int32) + cfg.kmin

    def step(carry, xs):
        level, ch_slice = xs  # ch_slice: [B, W] uint8 at this score level
        s, k, comp, act, fallback = carry
        acting = act & (s == level)
        # one-hot select of each acting pair's cell from the streamed slice
        onehot = karr[None, :] == k[:, None]
        ch = jnp.sum(jnp.where(onehot, ch_slice, jnp.uint8(0)),
                     axis=1).astype(jnp.int32)
        msrc = ch & 7
        at_m = comp == M
        stop_seed = acting & at_m & ((s <= 0) | (msrc == MSRC_SEED))
        bad = acting & at_m & (s > 0) & (msrc == MSRC_NONE)
        act2 = acting & ~stop_seed
        fallback = fallback | bad
        act2 = act2 & ~bad

        if is_linear:
            # comp is always M for linear metrics
            op = jnp.where(msrc == MSRC_X, WOP_X,
                           jnp.where(msrc == MSRC_I1, WOP_I, WOP_D))
            ds = jnp.where(msrc == MSRC_X, lin_x, lin_open)
            dk = jnp.where(msrc == MSRC_I1, -1,
                           jnp.where(msrc == MSRC_D1, 1, 0))
            new_comp = comp
            mflag = jnp.int32(WOP_MFLAG)
        else:
            i1_ext = (ch >> 3) & 1
            d1_ext = (ch >> 4) & 1
            i2_ext = (ch >> 5) & 1
            d2_ext = (ch >> 6) & 1
            # transitions per current comp
            # at M: follow msrc (into I/D chains when *_ext, else stay M)
            m_op = jnp.where(msrc == MSRC_X, WOP_X,
                             jnp.where((msrc == MSRC_I1) | (msrc == MSRC_I2),
                                       WOP_I, WOP_D))
            m_ds = jnp.where(
                msrc == MSRC_X, x,
                jnp.where(msrc == MSRC_I1, jnp.where(i1_ext == 1, e1, o1e1),
                          jnp.where(msrc == MSRC_D1, jnp.where(d1_ext == 1, e1, o1e1),
                                    jnp.where(msrc == MSRC_I2, jnp.where(i2_ext == 1, e2, o2e2),
                                              jnp.where(d2_ext == 1, e2, o2e2)))))
            m_dk = jnp.where((msrc == MSRC_I1) | (msrc == MSRC_I2), -1,
                             jnp.where((msrc == MSRC_D1) | (msrc == MSRC_D2), 1, 0))
            m_next = jnp.where(
                msrc == MSRC_X, M,
                jnp.where(msrc == MSRC_I1, jnp.where(i1_ext == 1, I1, M),
                          jnp.where(msrc == MSRC_D1, jnp.where(d1_ext == 1, D1, M),
                                    jnp.where(msrc == MSRC_I2, jnp.where(i2_ext == 1, I2, M),
                                              jnp.where(d2_ext == 1, D2, M)))))
            # at I1/D1/I2/D2: ext continues the chain, open returns to M
            c_op = jnp.where((comp == I1) | (comp == I2), WOP_I, WOP_D)
            c_ext = jnp.where(comp == I1, i1_ext,
                              jnp.where(comp == D1, d1_ext,
                                        jnp.where(comp == I2, i2_ext, d2_ext)))
            c_e = jnp.where((comp == I1) | (comp == D1), e1, e2)
            c_oe = jnp.where((comp == I1) | (comp == D1), o1e1, o2e2)
            c_ds = jnp.where(c_ext == 1, c_e, c_oe)
            c_dk = jnp.where((comp == I1) | (comp == I2), -1, 1)
            c_next = jnp.where(c_ext == 1, comp, M)

            op = jnp.where(at_m, m_op, c_op)
            ds = jnp.where(at_m, m_ds, c_ds)
            dk = jnp.where(at_m, m_dk, c_dk)
            new_comp = jnp.where(at_m, m_next, c_next)
            mflag = jnp.where(at_m, WOP_MFLAG, 0)

        act_new = act & ~(stop_seed | bad)
        move = act_new & acting
        emit = jnp.where(move, (op | mflag).astype(jnp.uint8), jnp.uint8(0))
        s2 = jnp.where(move, s - ds, s)
        k2 = jnp.where(move, k + dk, k)
        comp2 = jnp.where(move, new_comp, comp)
        # a chain pointing before score 0 is inconsistent -> fallback
        bad2 = move & (s2 < 0)
        fallback = fallback | bad2
        act_new = act_new & ~bad2
        return (s2, k2, comp2, act_new, fallback), emit

    return step


def _traceback_walk(cfg: EngineConfig, choices, final_s, end_k, ok):
    """Walk the choice tensor backwards from each pair's end cell.

    Emits per pair a zero-sparse op stream in FORWARD cigar order (codes
    WOP_* | WOP_MFLAG; 0 = no op at that level) plus the start diagonal.
    `ok`: [B] pairs with a clean END_REACHED result.
    Returns (ops_fwd [B, S_cap] uint8, n_ops [B], k_start [B], fallback [B]).
    """
    B = choices.shape[1]
    step = _walk_step_fn(cfg, B)
    carry0 = (final_s, end_k, jnp.zeros((B,), jnp.int32), ok,
              jnp.zeros((B,), bool))
    # walk as a chunked reverse scan CONSUMING the choices tensor as its
    # streamed xs. A while_loop that merely *reads* choices must carry
    # the whole [S_cap, B, W] buffer as a loop input, and inside a larger
    # fused program XLA's copy-insertion then re-copies it every
    # iteration (measured: 2.5 ms fused vs 0.15 ms standalone for the
    # same walk); scan streams one chunk per iteration instead. CH levels
    # per scan step amortize the [B]-sized op chain's fixed costs.
    CH = 4 if cfg.S_cap % 4 == 0 else (2 if cfg.S_cap % 2 == 0 else 1)
    nch = cfg.S_cap // CH
    ch_view = choices.reshape(nch, CH, B, choices.shape[2])
    bases = jnp.arange(nch, dtype=jnp.int32) * CH

    def chunk_step(carry, xs):
        base, chs = xs
        emits = [None] * CH
        for j in range(CH - 1, -1, -1):
            carry, emits[j] = step(carry, (base + j, chs[j]))
        return carry, jnp.stack(emits)

    (s_f, k_f, comp_f, act_f, fallback), ops_fwd = jax.lax.scan(
        chunk_step, carry0, (bases, ch_view), reverse=True)
    ops_fwd = ops_fwd.reshape(cfg.S_cap, B)
    # still active after all levels -> inconsistent chain
    fallback = fallback | act_f
    n_ops = jnp.sum((ops_fwd != 0).astype(jnp.int32), axis=0)
    # [B, S_cap], sparse (0 = no op at that score level), FORWARD cigar order
    return ops_fwd.T, n_ops, k_f, fallback


traceback_walk = functools.partial(jax.jit, static_argnums=(0,))(
    _traceback_walk)


def _compact_ops(ops_fwd, OC: int):
    """[B, S] zero-sparse op stream -> its first OC nonzero tokens, in
    order, zero-filled: an integer scatter to position cumsum(nz) - 1.

    Positions are distinct per row, so no two tokens collide; zeros and
    tokens past OC go to the drop column OC, which is sliced off. (Pairs
    with more than OC ops are flagged by the caller and re-run.)
    """
    B = ops_fwd.shape[0]
    nz = ops_fwd != 0
    pos = jnp.where(nz, jnp.cumsum(nz.astype(jnp.int32), axis=1) - 1,
                    jnp.int32(OC))
    pos = jnp.minimum(pos, OC)
    rows = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                            pos.shape)
    # int32 add: positions below OC are distinct, so add == set there,
    # and the summed drop column is discarded
    comp = jnp.zeros((B, OC + 1), jnp.int32).at[rows, pos].add(
        ops_fwd.astype(jnp.int32))
    return comp[:, :OC].astype(jnp.uint8)


def packed_layout(cfg: EngineConfig) -> str:
    """Static layout of the _pack_full output vector (single source of
    truth for encoder and decoder):

    - "full":    7*B int32 meta [status, final_s, end_k, end_off, n_ops,
                 k_start, fallback] + ops_fwd [B, S_cap] sparse stream.
    - "compact": per-pair 14-byte meta -- [B] status u8, [B] fallback u8,
                 [4, B] int16 (final_s, end_k, n_ops, k_start), [B] int32
                 end_off -- + the 4-bit-packed [B, ops_out//2] compacted
                 op stream. Chosen when ops_out is active and every field
                 fits (fewer device->host bytes).
    """
    if not (0 < cfg.ops_out < cfg.S_cap):
        return "full"
    fits = (cfg.S_cap <= 32767 and cfg.W <= 65534
            and (cfg.Lt + cfg.extend_chunk) <= 2**31 - 1)
    return "compact" if fits else "full"


def _pack_full(cfg: EngineConfig, out):
    """Walk + pack ALL full-scope outputs into ONE uint8 vector.

    See packed_layout for the wire format (decoded by
    batch.align_pairs_finish). Keeping walk + packing in the SAME
    compiled program as the score loop makes a whole batch ONE jit
    dispatch + ONE device->host pull.
    """
    # walk clean completions AND droppped/unreachable pairs with a recorded
    # end position (z-drop): the reference backtraces those too, from the
    # historic-max cell at the drop score (wavefront_unialign.c:211-235 +
    # heuristic.c:425-435); the host then applies cigar_maxtrim. Recorded
    # choices equal the re-derived backtrace argmax because every band
    # prune lands before any dependent compute reads the pruned level.
    ok = (out["status"] == ST_END_REACHED) | (
        (out["status"] == ST_END_UNREACHABLE)
        & (out["end_off"] > NULL_THRESHOLD))
    ops_fwd, n_ops, k_start, fb = _traceback_walk(
        cfg, out["choices"], out["final_s"], out["end_k"], ok)
    status = out["status"]
    if packed_layout(cfg) == "compact":
        OC = cfg.ops_out
        assert OC % 2 == 0
        comp = _compact_ops(ops_fwd, OC)
        # 4-bit pack (tokens are WOP_*|WOP_MFLAG <= 7)
        ops_stream = comp[:, 0::2] | (comp[:, 1::2] << 4)
        # overflowing walks re-run at the next rung (never set at the
        # terminal full-caps rung, where ops_out == 0)
        status = jnp.where(ok & (n_ops > OC),
                           jnp.int32(ST_OVERFLOW_S), status)
        m16 = jnp.stack([out["final_s"], out["end_k"], n_ops,
                         k_start]).astype(jnp.int16)
        return jnp.concatenate([
            status.astype(jnp.uint8),
            fb.astype(jnp.uint8),
            jax.lax.bitcast_convert_type(m16, jnp.uint8).reshape(-1),
            jax.lax.bitcast_convert_type(
                out["end_off"].astype(jnp.int32), jnp.uint8).reshape(-1),
            ops_stream.reshape(-1)])
    meta = jnp.stack([status, out["final_s"], out["end_k"],
                      out["end_off"], n_ops, k_start,
                      fb.astype(jnp.int32)])
    return jnp.concatenate([
        jax.lax.bitcast_convert_type(meta, jnp.uint8).reshape(-1),
        ops_fwd.reshape(-1)])


def _pack_meta(out):
    """Score-only scope: the 4xB int32 meta block (one dispatch, one pull)."""
    return jnp.stack([out["status"], out["final_s"], out["end_k"],
                      out["end_off"]])


pack_full_output = functools.partial(jax.jit, static_argnums=(0,))(_pack_full)
pack_meta_output = jax.jit(_pack_meta)


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch_full(cfg: EngineConfig, pat, txt, plen, tlen, frees,
                     max_steps):
    """align_batch + traceback walk + output packing, one compiled call."""
    return _pack_full(cfg, _align_core(cfg, pat, txt, plen, tlen, frees,
                                       max_steps))


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch_fused_full(cfg: EngineConfig, fused, plen, tlen, frees,
                           max_steps):
    """align_batch_fused + walk + packing, one compiled call."""
    pat, txt = _decode_fused(cfg, fused)
    return _pack_full(cfg, _align_core(cfg, pat, txt, plen, tlen, frees,
                                       max_steps))


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch_packed_full(cfg: EngineConfig, packed, plen, tlen, frees,
                            max_steps):
    """align_batch_packed + walk + packing, one compiled call."""
    plen = plen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    pat, txt = _decode_packed(cfg, packed, plen, tlen)
    return _pack_full(cfg, _align_core(cfg, pat, txt, plen, tlen, frees,
                                       max_steps))


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch_fused_meta(cfg: EngineConfig, fused, plen, tlen, frees,
                           max_steps):
    """Score-only align_batch_fused returning the packed meta block."""
    pat, txt = _decode_fused(cfg, fused)
    return _pack_meta(_align_core(cfg, pat, txt, plen, tlen, frees,
                                  max_steps))


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch_packed_meta(cfg: EngineConfig, packed, plen, tlen, frees,
                            max_steps):
    """Score-only align_batch_packed returning the packed meta block."""
    plen = plen.astype(jnp.int32)
    tlen = tlen.astype(jnp.int32)
    pat, txt = _decode_packed(cfg, packed, plen, tlen)
    return _pack_meta(_align_core(cfg, pat, txt, plen, tlen, frees,
                                  max_steps))


def _walk_segment(cfg: EngineConfig, choices, seg_base, carry):
    """Walk one segment's choices block (levels [seg_base, seg_base+S_cap)).

    `carry` = (s, k, comp, active, fallback) per pair; start from
    walk_carry_init(...) at the topmost segment and feed each segment's
    returned carry into the next-lower one. Returns (ops_fwd [B, S_cap],
    carry). After the bottom segment, pairs still active are inconsistent
    (fallback).
    """
    B = choices.shape[1]
    step = _walk_step_fn(cfg, B)
    idx = jnp.arange(cfg.S_cap, dtype=jnp.int32)
    levels = seg_base + idx
    # slot 0 of a non-bottom segment aliases the previous segment's top
    # level (compute writes indices [1, S_cap-1] per segment); mask it out
    levels = jnp.where((idx == 0) & (seg_base > 0), jnp.int32(-2**30),
                       levels)
    carry, ops_fwd = jax.lax.scan(step, carry, (levels, choices),
                                  reverse=True)
    return ops_fwd.T, carry


traceback_walk_segment = functools.partial(jax.jit, static_argnums=(0,))(
    _walk_segment)


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch_start_walk(cfg: EngineConfig, pat, txt, plen, tlen, frees,
                           max_steps, carry):
    """Rematerialize segment 0 (from the initial state) WITH choice
    recording and walk its levels, all in one compiled call.

    The walk-phase twin of align_batch_start for the rematerialized
    long-read path: the forward pass ran without recording choices
    (device memory = ring only); the walk re-runs each segment to
    regenerate its choices block on device and immediately consumes it --
    the block never leaves the compiled program, so device memory stays
    bounded by ONE segment regardless of the total score (the tensor
    answer to BiWFA's O(s) memory, wavefront_bialign.c:48-750, via
    recomputation instead of meet-in-the-middle bisection).
    """
    B = pat.shape[0]
    state = _init_state(cfg, B, plen, tlen, frees, max_steps)
    state = _run_loop(cfg, state, pat, txt, plen, tlen, frees, max_steps)
    return _walk_segment(cfg, state["choices"], jnp.int32(0), carry)


@functools.partial(jax.jit, static_argnums=(0,))
def align_batch_replay_walk(cfg: EngineConfig, pat, txt, plen, tlen, frees,
                            max_steps, state, carry):
    """Rematerialize one segment from its boundary `state` (as saved by the
    forward pass) WITH choice recording, and walk its levels -- one
    compiled call, choices block stays on device (see
    align_batch_start_walk). `cfg` must have record_choices=True; `state`
    comes from a record_choices=False forward run (no choices buffer)."""
    state = dict(state)
    seg_base = state["s"]
    state["seg_base"] = seg_base
    B = pat.shape[0]
    state["choices"] = jnp.zeros((cfg.S_cap, B, cfg.W), dtype=jnp.uint8)
    state = _run_loop(cfg, state, pat, txt, plen, tlen, frees, max_steps)
    return _walk_segment(cfg, state["choices"], seg_base, carry)


def walk_carry_init(final_s, end_k, ok):
    import numpy as _np
    B = len(final_s)
    return (jnp.asarray(final_s, dtype=jnp.int32),
            jnp.asarray(end_k, dtype=jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.asarray(ok),
            jnp.zeros((B,), bool))
