"""SPMD data-parallel alignment over a device mesh.

The reference has no distribution story at all (one `wavefront_align` call =
one pair on one core; see SURVEY.md §2.5). The batched replacement is
batch data-parallelism: read pairs are sharded over a 1-D device mesh with
`jax.sharding`, every device runs the identical wavefront program on its
shard, and the only collectives are result gathers of the small per-pair
meta arrays; sequences stream in pre-sharded. The mesh follows the batch
axis alone: it assumes no device topology (cards of one host joined all
to all, or hosts across a network, look the same to it).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import engine as E

DATA_AXIS = "data"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (DATA_AXIS,))


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (jax.distributed); no-op when single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def sharded_align_batch(cfg: E.EngineConfig, mesh: Mesh,
                        gather_results: bool = False):
    """jit `align_batch` with all per-pair arrays sharded over the batch.

    Every tensor in the engine carries the batch dimension, so a pure
    batch-axis NamedSharding lets XLA run the whole score loop with zero
    cross-device communication. With gather_results=True the small
    per-pair meta arrays (status/final_s/end_k/end_off/steps) come back
    fully replicated -- an all-gather over the device interconnect, the
    only collective of the data-parallel design (SURVEY §2.5 north star); the big
    choices tensor (if recorded) stays batch-sharded so no bulk data
    crosses the interconnect.
    """
    batch_1d = NamedSharding(mesh, P(DATA_AXIS))
    batch_2d = NamedSharding(mesh, P(DATA_AXIS, None))
    repl = NamedSharding(mesh, P())

    in_shardings = (batch_2d, batch_2d, batch_1d, batch_1d, batch_2d, repl)

    def fn(pat, txt, plen, tlen, frees, max_steps):
        return E.align_batch(cfg, pat, txt, plen, tlen, frees, max_steps)

    if not gather_results:
        return jax.jit(fn, in_shardings=in_shardings)
    out_shardings = dict(status=repl, final_s=repl, end_k=repl,
                         end_off=repl, steps=repl)
    if cfg.record_choices:
        out_shardings["choices"] = NamedSharding(mesh, P(None, DATA_AXIS,
                                                         None))
    return jax.jit(fn, in_shardings=in_shardings,
                   out_shardings=out_shardings)


def make_global_batch(mesh: Mesh, host_arrays: dict) -> dict:
    """Turn full host copies of the batch arrays into globally-sharded
    jax.Arrays (every process holds the same full host copy and
    contributes its addressable shards -- no cross-process data exchange
    at input time, matching the replicated-input north star)."""
    out = {}
    for name, (arr, spec) in host_arrays.items():
        sh = NamedSharding(mesh, spec)
        out[name] = jax.make_array_from_callback(
            arr.shape, sh, lambda idx, a=arr: a[idx])
    return out
