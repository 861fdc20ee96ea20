"""Multi-process scaling measurement (CPU multi-host simulation).

Launches tools/mp_worker.py at 1, 2, and 4 processes (2 virtual CPU
devices each) with the global batch scaled proportionally (weak scaling:
B = B_PER_DEV * n_devices), records aggregate pairs/s per point, and
writes SCALING_r{N}.json.

Caveat recorded in the artifact: all simulated "hosts" share one
machine's cores, so efficiency here validates the distributed PROTOCOL
(global mesh, sharded inputs, gather collective, identical results), not
real interconnect scaling.

CPU-only by design (the workers force the CPU backend): a JAX process
reserves most of a GPU's memory when it first touches it, so several
processes must not share one card.

Usage: python tools/bench_multiprocess.py [out.json]
"""
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "mp_worker.py")

B_PER_DEV = int(os.environ.get("SCALE_B_PER_DEV", 64))
L = int(os.environ.get("SCALE_L", 150))
ITERS = int(os.environ.get("SCALE_ITERS", 32))
DEV_PER_PROC = 2


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_point(nproc, tmpdir, B=None):
    if B is None:
        B = B_PER_DEV * DEV_PER_PROC * nproc
    port = free_port()
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={DEV_PER_PROC}")
    env.pop("JAX_PLATFORMS", None)
    procs, outs = [], []
    for pid in range(nproc):
        out = os.path.join(tmpdir, f"scale_{nproc}_{pid}.json")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port),
             str(B), str(L), str(ITERS), out], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    for p in procs:
        _, se = p.communicate(timeout=1200)
        if p.returncode != 0:
            raise RuntimeError(se.decode()[-2000:])
    recs = [json.load(open(o)) for o in outs]
    assert all(r["meta"] == recs[0]["meta"] for r in recs), \
        "processes disagree on gathered results"
    s_per_batch = max(r["s_per_batch"] for r in recs)
    s_nogather = max(r["s_per_batch_nogather"] for r in recs)
    s_local = max(r["s_per_batch_local"] for r in recs)
    # point noise floor: worst per-iteration stddev across processes and
    # variants -- a decomposition difference below this is indistinguishable
    # from measurement noise and is reported as such, never negative
    noise = max(max(r["s_per_batch_std"], r["s_per_batch_nogather_std"],
                    r["s_per_batch_local_std"]) for r in recs)
    gather_raw = s_per_batch - s_nogather
    dist_raw = s_nogather - s_local
    return dict(num_processes=nproc, global_devices=DEV_PER_PROC * nproc,
                B=B, L=L, s_per_batch=s_per_batch,
                s_per_batch_std=round(max(r["s_per_batch_std"]
                                          for r in recs), 5),
                pairs_per_s=B / s_per_batch,
                # decomposition (see note): gather collective cost, and
                # the same per-device shard on a LOCAL-only mesh under
                # this point's CPU contention
                gather_overhead_s=round(max(gather_raw, 0.0), 5),
                gather_below_noise=bool(abs(gather_raw) < noise),
                gather_bytes=recs[0]["gather_bytes"],
                s_per_batch_local=s_local,
                distributed_overhead_s=round(max(dist_raw, 0.0), 5),
                distributed_below_noise=bool(abs(dist_raw) < noise),
                noise_floor_s=round(noise, 5))


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "SCALING_r05.json"
    points = []
    strong_points = []
    B_strong = B_PER_DEV * DEV_PER_PROC * 4
    with tempfile.TemporaryDirectory() as td:
        for nproc in (1, 2, 4):
            pt = run_point(nproc, td)
            points.append(pt)
            print(f"weak   {nproc} proc ({pt['global_devices']} dev): "
                  f"{pt['pairs_per_s']:.0f} pairs/s (B={pt['B']}, "
                  f"gather +{pt['gather_overhead_s']*1e3:.1f} ms, "
                  f"dist +{pt['distributed_overhead_s']*1e3:.1f} ms)",
                  flush=True)
        for nproc in (1, 2, 4):
            pt = run_point(nproc, td, B=B_strong)
            strong_points.append(pt)
            print(f"strong {nproc} proc ({pt['global_devices']} dev): "
                  f"{pt['pairs_per_s']:.0f} pairs/s (B={pt['B']})",
                  flush=True)
    base = points[0]["pairs_per_s"]
    for pt in points:
        pt["scaling_efficiency"] = round(
            pt["pairs_per_s"] / (base * pt["num_processes"]), 3)
        # efficiency with shared-core contention factored out: each
        # point's own local-mesh run is the contention-matched baseline,
        # so this ratio isolates what the GLOBAL mesh costs
        pt["device_weighted_efficiency"] = round(
            pt["s_per_batch_local"] / pt["s_per_batch"], 3)
    sbase = strong_points[0]["pairs_per_s"]
    for pt in strong_points:
        pt["scaling_efficiency"] = round(
            pt["pairs_per_s"] / (sbase * pt["num_processes"]), 3)
        pt["device_weighted_efficiency"] = round(
            pt["s_per_batch_local"] / pt["s_per_batch"], 3)
    rec = dict(
        kind="scaling_cpu_simulation",
        note=("CPU multi-process simulation of multi-host: validates the "
              "jax.distributed protocol and result parity. All simulated "
              "hosts share ONE machine's cores, so raw efficiency "
              "conflates CPU contention with distribution cost; the "
              "decomposition columns separate them: gather_overhead_s = "
              "wall - no-gather twin (the collective), "
              "distributed_overhead_s = no-gather - local-only mesh "
              "(global-mesh/sync cost), device_weighted_efficiency = "
              "local-mesh time / wall under identical contention (1.0 = "
              "the global mesh is free). The gather moves gather_bytes "
              "= 16 B/pair (4 int32 meta arrays; e.g. 8.2 KB at "
              "B=512); the milliseconds measured here are "
              "Gloo-over-TCP loopback cost, a property of the CPU "
              "simulation, not of the collective. Overheads are clamped "
              "at 0 and flagged *_below_noise when |raw| < the point's "
              "per-iteration stddev (noise_floor_s)."),
        b_per_device=B_PER_DEV, dev_per_proc=DEV_PER_PROC, iters=ITERS,
        weak_scaling=points, strong_scaling=strong_points)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
