"""Sequence encodings: ASCII <-> 2-bit packed DNA.

Analog of the reference's packed-2-bits input mode
(`wavefront_align_packed2bits`, wavefront_align.c:150-241 +
wavefront_sequences.c:102-140 2-bit decode): ACGT <-> {0,1,2,3}, 4 bases per
byte, little-end first. The engine consumes ASCII int8 tokens, so packed
input is unpacked on ingestion; packing exists for compact storage/transport
of large read sets.
"""
from __future__ import annotations

import numpy as np

_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b + 32] = _i  # lowercase
_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


def pack2bits(seq: bytes) -> np.ndarray:
    """ASCII ACGT -> packed uint8 array (4 bases/byte, LSB-first)."""
    codes = _CODE[np.frombuffer(seq, dtype=np.uint8)]
    if (codes == 255).any():
        raise ValueError("packed2bits input must be ACGT/acgt only")
    n = len(codes)
    pad = (-n) % 4
    codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    c = codes.reshape(-1, 4).astype(np.uint16)
    packed = (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6))
    return packed.astype(np.uint8)


def unpack2bits(packed: np.ndarray, length: int) -> bytes:
    """Packed uint8 array -> ASCII ACGT bytes of `length` bases."""
    p = np.asarray(packed, dtype=np.uint8)
    codes = np.empty((len(p), 4), dtype=np.uint8)
    codes[:, 0] = p & 3
    codes[:, 1] = (p >> 2) & 3
    codes[:, 2] = (p >> 4) & 3
    codes[:, 3] = (p >> 6) & 3
    return _BASE[codes.reshape(-1)[:length]].tobytes()
