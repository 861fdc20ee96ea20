"""Multi-process (multi-host-simulating) alignment worker.

One OS process per simulated host; `jax.distributed` + Gloo CPU
collectives stitch the per-process CPU devices into one global mesh, and
`parallel.mesh.sharded_align_batch` runs the batched engine data-parallel
across it (SURVEY §4: multi-host testing via CPU multi-process
simulation). Launched by tests/test_multiprocess.py and
tools/bench_multiprocess.py:

    python tools/mp_worker.py <pid> <nproc> <port> <B> <L> <iters> <out.json>

Every process builds the identical corpus (seeded) and contributes its
local shards; results come back replicated via the gather collective, and
each process writes its own JSON (the launcher checks process agreement).

CPU-only by design: every process forces the CPU backend. A JAX process
reserves most of a GPU's memory when it first touches it, so several
processes must not share one card.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# CPU runs skip the persistent compile cache (XLA:CPU AOT
# (de)serialization can segfault; see tests/conftest.py)
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402


def make_corpus(B, L, seed=7):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pats = alpha[rng.integers(0, 4, (B, L))]
    txts = pats.copy()
    for i in range(B):
        idx = rng.choice(L, 3, replace=False)
        txts[i, idx] = alpha[rng.integers(0, 4, 3)]
    return ([pats[i].tobytes() for i in range(B)],
            [txts[i].tobytes() for i in range(B)])


def main():
    pid, nproc, port, B, L, iters = (int(a) for a in sys.argv[1:7])
    out_path = sys.argv[7]

    # distributed bring-up must precede any backend touch (the package
    # import is safe: it only sets config flags)
    from pywfa_tpu.parallel.mesh import (distributed_init, make_mesh,
                                         make_global_batch,
                                         sharded_align_batch)
    distributed_init(coordinator_address=f"localhost:{port}",
                     num_processes=nproc, process_id=pid)
    mesh = make_mesh()

    from pywfa_tpu.align import WavefrontAligner
    from pywfa_tpu.batch import (PATTERN_SENTINEL, TEXT_SENTINEL,
                                 encode_batch)
    from pywfa_tpu.ops import engine as E

    pats, txts = make_corpus(B, L)
    attr = WavefrontAligner(backend="numpy", span="end-to-end",
                            scope="score")._attributes()
    cfg = E.full_config(attr, L, L, record_choices=False)
    C = cfg.extend_chunk
    host = dict(
        pat=(encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL), P("data", None)),
        txt=(encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL), P("data", None)),
        plen=(np.full((B,), L, np.int32), P("data")),
        tlen=(np.full((B,), L, np.int32), P("data")),
        frees=(np.zeros((B, 4), np.int32), P("data", None)),
    )
    g = make_global_batch(mesh, host)
    ms = jnp.int32(2**31 - 1)
    fn = sharded_align_batch(cfg, mesh, gather_results=True)

    def run():
        return fn(g["pat"], g["txt"], g["plen"], g["tlen"], g["frees"], ms)

    out = run()  # compile + warm
    meta = {k: np.asarray(out[k]).tolist()
            for k in ("status", "final_s", "end_k", "end_off")}

    def timed(fn_run, key):
        """Per-iteration wall times -> (median, stddev)."""
        ts = []
        for _ in range(iters):
            t0 = time.time()
            o = fn_run()
            jax.block_until_ready(o[key])
            ts.append(time.time() - t0)
        a = np.asarray(ts)
        return float(np.median(a)), float(a.std())

    dt, dt_std = timed(run, "status")

    # --- overhead decomposition ---
    # (a) no-gather twin: identical sharded computation, results left
    # batch-sharded -> dt - dt_nogather isolates the gather collective
    fn_ng = sharded_align_batch(cfg, mesh, gather_results=False)

    def run_ng():
        return fn_ng(g["pat"], g["txt"], g["plen"], g["tlen"], g["frees"],
                     ms)
    run_ng()  # warm
    dt_nogather, dt_ng_std = timed(run_ng, "status")

    # (b) local-only control: the SAME per-device shard on a mesh of just
    # this process's devices (no jax.distributed in the program) -> pure
    # local compute under the point's CPU contention; dt_nogather -
    # dt_local isolates multi-process/global-mesh overhead beyond the
    # collective itself
    lmesh = make_mesh(jax.local_devices())
    Bl = B * len(jax.local_devices()) // len(jax.devices())
    host_l = {k: (a[:Bl], s) for k, (a, s) in host.items()}
    gl = make_global_batch(lmesh, host_l)
    fn_l = sharded_align_batch(cfg, lmesh, gather_results=False)

    def run_l():
        return fn_l(gl["pat"], gl["txt"], gl["plen"], gl["tlen"],
                    gl["frees"], ms)
    run_l()  # warm
    dt_local, dt_l_std = timed(run_l, "status")

    # bytes the gather collective actually moves: the 4 per-pair int32
    # meta arrays, gathered from shards to full replication
    gather_bytes = 4 * 4 * B

    rec = dict(process_id=pid, num_processes=nproc,
               local_devices=len(jax.local_devices()),
               global_devices=len(jax.devices()),
               B=B, L=L, s_per_batch=dt, s_per_batch_std=dt_std,
               pairs_per_s=B / dt,
               s_per_batch_nogather=dt_nogather,
               s_per_batch_nogather_std=dt_ng_std,
               s_per_batch_local=dt_local, s_per_batch_local_std=dt_l_std,
               gather_bytes=gather_bytes, meta=meta)
    with open(out_path, "w") as f:
        json.dump(rec, f)
    print(f"proc {pid}/{nproc}: {B / dt:.0f} pairs/s "
          f"({len(jax.devices())} global devices)", flush=True)


if __name__ == "__main__":
    main()
