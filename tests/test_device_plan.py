"""Device-facing decisions made on the host: memory budgets read from the
device, the compile-cache location, the extension formulation chosen by
length, the walk-op compaction, and chip_smoke.py refusing a machine
without a GPU."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import pywfa_tpu
from pywfa_tpu import batch
from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.ops import engine as E

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_mem_caps_gpu_share_of_bytes_limit():
    limit = 64 * 2**30
    caps = batch.mem_caps_for("gpu", limit)
    assert caps == batch.MemCaps(lcp_table=12 * 2**30, choices=16 * 2**30,
                                 replay_choices=2 * 2**30,
                                 lcp_table_remat=32 * 2**30)
    # the CPU budgets are the same shares of a 16 GiB device
    assert batch.mem_caps_for("gpu", 16 * 2**30) == batch.CPU_MEM_CAPS


def test_mem_caps_cpu_fixed_and_unknown_platform_errors():
    assert batch.mem_caps_for("cpu", None) == batch.CPU_MEM_CAPS
    assert batch.mem_caps_for("cpu", 2**40) == batch.CPU_MEM_CAPS
    with pytest.raises(RuntimeError, match="platform"):
        batch.mem_caps_for("rocm", 16 * 2**30)
    with pytest.raises(RuntimeError, match="bytes_limit"):
        batch.mem_caps_for("gpu", None)


def test_device_mem_caps_reads_memory_stats(monkeypatch):
    class FakeGpu:
        platform = "gpu"

        def memory_stats(self):
            return {"bytes_limit": 80 * 2**30, "bytes_in_use": 0}

    monkeypatch.setattr(jax, "devices", lambda: [FakeGpu()])
    batch.device_mem_caps.cache_clear()
    try:
        caps = batch.device_mem_caps()
    finally:
        batch.device_mem_caps.cache_clear()
    assert caps == batch.mem_caps_for("gpu", 80 * 2**30)
    assert caps.choices == 20 * 2**30


def test_device_mem_caps_on_cpu():
    batch.device_mem_caps.cache_clear()
    assert batch.device_mem_caps() == batch.CPU_MEM_CAPS


def test_compile_cache_dir_fixed_in_checkout():
    d = pywfa_tpu.compile_cache_dir({})
    assert d == pywfa_tpu.CACHE_DIR
    assert os.path.dirname(d) == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert os.path.basename(d) + "/" in fh.read().split()


def test_compile_cache_dir_defers_to_env():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}
    assert pywfa_tpu.compile_cache_dir(env) is None
    assert pywfa_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": ""}) == pywfa_tpu.CACHE_DIR


def _cfg(**kw):
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    return dataclasses.replace(E.full_config(attr, 150, 150), **kw)


@pytest.mark.parametrize("Ltp,mode", [(80, "bits"), (176, "bits"),
                                      (E.BITS_MAX_LTP, "bits"),
                                      (E.BITS_MAX_LTP + 1, "table"),
                                      (1040, "table"), (10256, "table")])
def test_extend_mode_default_by_length(Ltp, mode):
    assert E._extend_mode(_cfg(), Ltp) == mode


def test_extend_mode_forced_and_table_disabled():
    assert E._extend_mode(_cfg(use_lcp_table=False), 176) == "chunk"
    assert E._extend_mode(_cfg(use_lcp_table=False,
                               extend_force="bits"), 176) == "chunk"
    assert E._extend_mode(_cfg(extend_force="table"), 176) == "table"
    assert E._extend_mode(_cfg(extend_force="bits"), 4000) == "bits"
    assert E._extend_mode(_cfg(extend_force="onehot4"), 176) == "onehot4"
    assert E._extend_mode(_cfg(extend_force="onehot4"), 400) == "onehot"
    assert E._extend_mode(_cfg(extend_force="onehot"),
                          E.HMAJOR_MAX_LTP + 1) == "table"


def _compact_einsum(ops_fwd, OC):
    """The one-hot float32 product the integer scatter replaced."""
    nz = ops_fwd != 0
    pos = jnp.where(nz, jnp.cumsum(nz.astype(jnp.int32), axis=1) - 1,
                    jnp.int32(OC))
    oh = jax.nn.one_hot(pos, OC, dtype=jnp.float32)
    comp = jnp.einsum("bs,bso->bo", ops_fwd.astype(jnp.float32), oh,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    return comp.astype(jnp.uint8)


def test_compact_ops_equals_onehot_product():
    rng = np.random.default_rng(3)
    B, S, OC = 64, 96, 32
    toks = rng.integers(1, 8, (B, S)).astype(np.uint8)
    density = rng.random((B, 1)) * 0.6  # some rows overflow OC
    ops = np.where(rng.random((B, S)) < density, toks, 0).astype(np.uint8)
    ops[0] = 0  # an empty walk
    got = np.asarray(E._compact_ops(jnp.asarray(ops), OC))
    ref = np.asarray(_compact_einsum(jnp.asarray(ops), OC))
    np.testing.assert_array_equal(got, ref)
    # and by definition: the first OC nonzero tokens, in order
    for b in range(B):
        nzt = ops[b][ops[b] != 0][:OC]
        np.testing.assert_array_equal(got[b, :len(nzt)], nzt)
        assert not got[b, len(nzt):].any()


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "'cpu'" in r.stdout + r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        (tmp_path / "chip_smoke.py").write_text(fh.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
