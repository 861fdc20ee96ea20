"""Multi-process distributed execution (multi-host simulation on CPU).

Launches 2 OS processes, each with 2 virtual CPU devices, joined by
`jax.distributed` (Gloo collectives) into one 4-device global mesh; the
sharded engine must produce results identical to a single-process run
(SURVEY §4: "test multi-host with jax.distributed on CPU multi-process
simulation"; BASELINE multi-host measurement protocol lives in
tools/bench_multiprocess.py). CPU-only by design: the workers force the
CPU backend, since several JAX processes must not share one GPU.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "mp_worker.py")

B, L = 16, 64


def _free_port():
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(nproc, port, tmp_path, iters=1):
    procs = []
    outs = []
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env.pop("JAX_PLATFORMS", None)
    for pid in range(nproc):
        out = tmp_path / f"mp_{nproc}_{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port),
             str(B), str(L), str(iters), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    recs = []
    for p in procs:
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, se.decode()[-2000:]
    for out in outs:
        recs.append(json.loads(out.read_text()))
    return recs


def test_two_process_matches_single(tmp_path):
    # port probing is racy (another process can bind between probe and
    # coordinator bring-up); retry once on a fresh port
    try:
        recs2 = _launch(2, _free_port(), tmp_path)
    except (AssertionError, subprocess.TimeoutExpired):
        recs2 = _launch(2, _free_port(), tmp_path)
    assert all(r["global_devices"] == 4 for r in recs2)
    assert all(r["local_devices"] == 2 for r in recs2)
    # both processes must see the SAME gathered (replicated) results
    assert recs2[0]["meta"] == recs2[1]["meta"]
    # and they must equal a single-process run of the same corpus
    recs1 = _launch(1, _free_port(), tmp_path)
    assert recs1[0]["meta"] == recs2[0]["meta"]
    # sanity: the corpus actually aligned
    assert all(s == 1 for s in recs2[0]["meta"]["status"])  # ST_END_REACHED
