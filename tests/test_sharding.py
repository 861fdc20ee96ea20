"""Multi-device SPMD tests on the virtual 8-device CPU mesh."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
from pywfa_tpu.ops import engine as E
from pywfa_tpu.parallel import bucket_pairs, make_mesh, sharded_align_batch
from jax.sharding import NamedSharding, PartitionSpec as P


@pytest.fixture
def eight_devices():
    """Skip unless 8 devices exist (tests/conftest.py gives the CPU 8
    virtual ones); decided when the test runs, never at import."""
    if len(jax.devices()) < 8:
        pytest.skip(f"needs 8 devices, found {len(jax.devices())}")


def _mk_batch(B, L, seed=0):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pats_a = alpha[rng.integers(0, 4, (B, L))]
    txts_a = pats_a.copy()
    for i in range(B):
        idx = rng.choice(L, 2, replace=False)
        txts_a[i, idx] = alpha[rng.integers(0, 4, 2)]
    return ([pats_a[i].tobytes() for i in range(B)],
            [txts_a[i].tobytes() for i in range(B)])


def test_sharded_matches_single_device(eight_devices):
    B, L = 32, 64
    pats, txts = _mk_batch(B, L)
    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    cfg = E.full_config(attr, L, L)
    C = cfg.extend_chunk
    pat = jnp.asarray(encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL))
    txt = jnp.asarray(encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL))
    plen = jnp.full((B,), L, jnp.int32)
    tlen = jnp.full((B,), L, jnp.int32)
    frees = jnp.zeros((B, 4), jnp.int32)
    ms = jnp.int32(2**31 - 1)

    ref = E.align_batch(cfg, pat, txt, plen, tlen, frees, ms)

    mesh = make_mesh(jax.devices()[:8])
    b1 = NamedSharding(mesh, P("data"))
    b2 = NamedSharding(mesh, P("data", None))
    fn = sharded_align_batch(cfg, mesh)
    out = fn(jax.device_put(pat, b2), jax.device_put(txt, b2),
             jax.device_put(plen, b1), jax.device_put(tlen, b1),
             jax.device_put(frees, b2), ms)
    for key in ("status", "final_s", "end_k", "end_off"):
        np.testing.assert_array_equal(np.asarray(out[key]),
                                      np.asarray(ref[key]), err_msg=key)
    np.testing.assert_array_equal(np.asarray(out["choices"]),
                                  np.asarray(ref["choices"]))


def test_sharded_endsfree_perpair_frees_and_heuristic(eight_devices):
    """Sharded step with varied PER-PAIR ends-free frees (multi-cell WF0
    seeding) and, separately, the wf-adaptive heuristic in-loop -- each
    byte-equal to the single-device run (the CI twin of
    __graft_entry__.dryrun_multichip configs 2-3)."""
    import dataclasses
    from pywfa_tpu.attributes import HeuristicParams
    from pywfa_tpu.constants import HeuristicStrategy

    B, L = 32, 64
    pats, txts = _mk_batch(B, L, seed=3)
    mesh = make_mesh(jax.devices()[:8])
    b1 = NamedSharding(mesh, P("data"))
    b2 = NamedSharding(mesh, P("data", None))

    def run_both(attr, frees_np):
        cfg = E.full_config(attr, L, L)
        C = cfg.extend_chunk
        pat = jnp.asarray(encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL))
        txt = jnp.asarray(encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL))
        plen = jnp.full((B,), L, jnp.int32)
        tlen = jnp.full((B,), L, jnp.int32)
        frees = jnp.asarray(frees_np)
        ms = jnp.int32(2**31 - 1)
        ref = E.align_batch(cfg, pat, txt, plen, tlen, frees, ms)
        fn = sharded_align_batch(cfg, mesh)
        out = fn(jax.device_put(pat, b2), jax.device_put(txt, b2),
                 jax.device_put(plen, b1), jax.device_put(tlen, b1),
                 jax.device_put(frees, b2), ms)
        for key in ("status", "final_s", "end_k", "end_off"):
            np.testing.assert_array_equal(np.asarray(out[key]),
                                          np.asarray(ref[key]), err_msg=key)

    # ends-free with per-pair varied frees
    api = WavefrontAligner(backend="numpy", span="ends-free",
                           pattern_begin_free=8, pattern_end_free=8,
                           text_begin_free=8, text_end_free=8)
    frees_v = np.zeros((B, 4), np.int32)
    frees_v[:, 0] = np.arange(B) % 9
    frees_v[:, 1] = 8
    frees_v[:, 2] = (np.arange(B) * 3) % 9
    frees_v[:, 3] = 8
    run_both(api._attributes(), frees_v)

    # wf-adaptive inside the sharded loop
    attr_h = dataclasses.replace(
        WavefrontAligner(backend="numpy", span="end-to-end")._attributes(),
        heuristic=HeuristicParams(strategy=HeuristicStrategy.WFADAPTIVE,
                                  min_wavefront_length=5,
                                  max_distance_threshold=15,
                                  steps_between_cutoffs=1))
    run_both(attr_h, np.zeros((B, 4), np.int32))


def test_bucketing():
    pats = [b"A" * 30, b"C" * 100, b"G" * 30, b"T" * 500]
    txts = [b"A" * 40, b"C" * 90, b"G" * 25, b"T" * 480]
    groups = bucket_pairs(pats, txts)
    assert groups[(64, 64)] == [0, 2]
    assert groups[(128, 128)] == [1]
    assert groups[(512, 512)] == [3]


def test_remat_under_mesh_matches_unsharded(eight_devices):
    """The segmented/remat engine sequence (align_batch_start/resume +
    replay walks) with batch-sharded inputs over the 8-device mesh must
    produce the identical segments, statuses and walked op streams as the
    unsharded run (CI twin of dryrun_multichip config 5)."""
    import dataclasses

    B, L = 32, 64
    pats, txts = _mk_batch(B, L, seed=5)
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    cfg0 = E.full_config(attr, L, L)
    cfg = dataclasses.replace(cfg0, S_cap=8, record_choices=False)
    cfg_rec = dataclasses.replace(cfg, record_choices=True)
    C = cfg.extend_chunk
    pat_np = encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL)
    txt_np = encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL)
    plen_np = np.array([len(p) for p in pats], np.int32)
    tlen_np = np.array([len(t) for t in txts], np.int32)
    frees_np = np.zeros((B, 4), np.int32)
    ms = jnp.int32(2**31 - 1)

    def run(shard):
        pat = jnp.asarray(pat_np)
        txt = jnp.asarray(txt_np)
        plen = jnp.asarray(plen_np)
        tlen = jnp.asarray(tlen_np)
        frees = jnp.asarray(frees_np)
        if shard:
            mesh = make_mesh(jax.devices()[:8])
            b1 = NamedSharding(mesh, P("data"))
            b2 = NamedSharding(mesh, P("data", None))
            pat = jax.device_put(pat, b2)
            txt = jax.device_put(txt, b2)
            plen = jax.device_put(plen, b1)
            tlen = jax.device_put(tlen, b1)
            frees = jax.device_put(frees, b2)
        out, state = E.align_batch_start(cfg, pat, txt, plen, tlen, frees,
                                         ms)
        snaps = []
        for _ in range(32):
            if not (np.asarray(out["status"]) == E.ST_OVERFLOW_S).any():
                break
            snaps.append({k: np.asarray(v) for k, v in state.items()})
            out, state = E.align_batch_resume(cfg, pat, txt, plen, tlen,
                                              frees, ms, state)
        status = np.asarray(out["status"])
        carry = E.walk_carry_init(jnp.asarray(out["final_s"]),
                                  jnp.asarray(out["end_k"]),
                                  jnp.asarray(status == E.ST_END_REACHED))
        blocks = []
        for i in range(len(snaps), -1, -1):
            if i == 0:
                ops_seg, carry = E.align_batch_start_walk(
                    cfg_rec, pat, txt, plen, tlen, frees, ms, carry)
            else:
                st = {k: jnp.asarray(v) for k, v in snaps[i - 1].items()}
                ops_seg, carry = E.align_batch_replay_walk(
                    cfg_rec, pat, txt, plen, tlen, frees, ms, st, carry)
            blocks.insert(0, np.asarray(ops_seg))
        fb = np.asarray(carry[4]) | np.asarray(carry[3])
        return (len(snaps), status, np.asarray(out["final_s"]),
                np.concatenate(blocks, axis=1), fb)

    n_ref, st_ref, fs_ref, ops_ref, fb_ref = run(shard=False)
    n_got, st_got, fs_got, ops_got, fb_got = run(shard=True)
    assert n_ref == n_got >= 1  # the config must actually segment
    assert not fb_ref.any() and not fb_got.any()
    np.testing.assert_array_equal(st_got, st_ref)
    np.testing.assert_array_equal(fs_got, fs_ref)
    np.testing.assert_array_equal(ops_got, ops_ref)
