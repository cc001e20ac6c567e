"""BGZF virtual file offsets [SPEC SAMv1 section 4.1.1]: the compressed
offset of a block start (48 bits) and the offset inside its inflated
payload (16 bits) packed into one 64-bit value."""
from __future__ import annotations

SHIFT = 16
UOFFSET_MASK = 0xFFFF


def make_voffset(coffset: int, uoffset: int) -> int:
    return (int(coffset) << SHIFT) | (int(uoffset) & UOFFSET_MASK)


def split_voffset(v: int) -> "tuple[int, int]":
    v = int(v)
    return v >> SHIFT, v & UOFFSET_MASK
