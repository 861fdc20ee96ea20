"""pywfa_tpu: batched wavefront sequence alignment in JAX.

A from-scratch JAX re-design of the capabilities of pywfa/WFA2-lib:
exact gap-affine / dual-affine / linear / edit / indel wavefront alignment
with full-CIGAR traceback, end-to-end and ends-free spans, score-only mode,
and adaptive/X-drop/Z-drop/banded pruning — executed as batched SPMD
programs over padded diagonal-band tensors.

Public pywfa-parity surface (reference: pywfa/__init__.py:1-6):
    WavefrontAligner, clip_cigartuples, cigartuples_to_str,
    elide_mismatches_from_cigar

Batched surface:
    pywfa_tpu.batch.BatchWavefrontAligner
"""
import os as _os

# fixed in-checkout location of the persistent XLA compile cache (listed
# in .gitignore); a fixed path keeps cache keys stable across processes
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ=_os.environ):
    """Directory this package sets for JAX's persistent compile cache:
    None when JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself),
    else CACHE_DIR. Engine configs are shape-bucketed and deterministic,
    so each compile is paid once per checkout."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def _enable_compile_cache() -> None:
    cache_dir = compile_cache_dir()
    if cache_dir is not None:
        import jax
        jax.config.update("jax_compilation_cache_dir", cache_dir)


_enable_compile_cache()

from .align import (  # noqa: F401,E402
    AlignmentResult,
    WavefrontAligner,
    clip_cigartuples,
    cigartuples_to_str,
    elide_mismatches_from_cigar,
)
from .attributes import register_match_classes  # noqa: F401,E402

__version__ = "0.1.0"

__all__ = [
    "WavefrontAligner",
    "AlignmentResult",
    "clip_cigartuples",
    "cigartuples_to_str",
    "elide_mismatches_from_cigar",
    "register_match_classes",
]
