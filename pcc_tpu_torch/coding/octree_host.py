"""Host-side octree bitstream serialization (numpy, vectorized): the
PyTorch port's copy of pcc_tpu/coding/octree_host.py.

Only the final bit emission/parsing lives on the host — a few hundred bits
per cloud. Layout matches the reference encoder (octree_np.py:10-45): bits
grouped by level (root first), within a level one 8-bit child-occupancy
group per occupied parent, parents in descending Morton order, child bits
emitted child-7 .. child-0 (the DFS pop order of octree_np.py:31-40).

Deliberate fixes vs the reference (SURVEY.md §7 known-defects list):
  * the reference decoder misaligns levels by one bit (octree_np.py:54
    consumes the root bit as part of level 1) and then pads/samples the
    result to a hardcoded 64 points (octree_np.py:100-111). Ours is the
    exact inverse of the encoder and derives the point count from the
    stream.
  * byte packing zero-pads the final byte on the right, so parsing is
    insensitive to tail padding (the reference's packer corrupts the last
    partial byte, pn_kit.py:463-467).
File size is identical: ceil((1 + 8*sum_l occ(l)) / 8) bytes.
"""

from __future__ import annotations

import numpy as np


def emit_octree_bits(codes_at_depth: np.ndarray, depth: int) -> np.ndarray:
    """Serialize unique voxel Morton codes at `depth` to a 0/1 bit array."""
    codes = np.unique(np.asarray(codes_at_depth, dtype=np.int64))  # ascending
    levels = [np.array([1], dtype=np.uint8)]
    for lvl in range(1, depth + 1):
        children = np.unique(codes >> (3 * (depth - lvl)))
        parents = np.unique(children >> 3)                 # ascending
        grid = np.zeros((len(parents), 8), dtype=np.uint8)
        rows = np.searchsorted(parents, children >> 3)
        grid[rows, children & 7] = 1
        # emission order: parents descending, children 7..0
        levels.append(grid[::-1, ::-1].reshape(-1))
    return np.concatenate(levels)


def parse_octree_bits(bits: np.ndarray):
    """Inverse of emit_octree_bits.

    Returns (codes [M] int64 in descending Morton order, depth). Trailing
    byte-padding bits are ignored: each level's group size is derived from
    the previous level's popcount, and parsing stops when the remaining
    bits cannot form a full level.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    if len(bits) == 0 or bits[0] != 1:
        raise ValueError("invalid octree bitstream (missing root bit)")
    codes = np.zeros(1, dtype=np.int64)  # level-0 occupied set = root
    depth = 0
    idx = 1
    while True:
        n = len(codes) * 8
        if idx + n > len(bits):
            break
        grid = bits[idx : idx + n].reshape(len(codes), 8)
        rows, cols = np.nonzero(grid)
        # rows ascend (parents already descending), cols ascend within a row
        # (children descending) -> new codes come out in descending order.
        codes = codes[rows] * 8 + (7 - cols)
        depth += 1
        idx += n
        if len(codes) == 0:
            raise ValueError("invalid octree bitstream (empty level)")
    return codes, depth


def codes_to_points(codes: np.ndarray, depth: int) -> np.ndarray:
    """Voxel centers [M, 3] float32 for Morton codes at `depth` (host mirror
    of octree.morton_decode), preserving input order."""
    codes = np.asarray(codes, dtype=np.int64)
    x = np.zeros_like(codes)
    y = np.zeros_like(codes)
    z = np.zeros_like(codes)
    for level in range(depth):
        shift = depth - 1 - level
        x |= ((codes >> (3 * shift + 2)) & 1) << shift
        y |= ((codes >> (3 * shift + 1)) & 1) << shift
        z |= ((codes >> (3 * shift)) & 1) << shift
    inv = 1.0 / float(1 << depth)
    return ((np.stack([x, y, z], axis=-1) + 0.5) * inv).astype(np.float32)


def pack_bits(bits: np.ndarray) -> bytes:
    """0/1 array -> bytes, first bit = MSB of first byte, zero-padded tail
    (same layout and size as pn_kit.py:463-467 minus its tail corruption)."""
    return np.packbits(np.asarray(bits, dtype=np.uint8)).tobytes()


def unpack_bits(byte_stream: bytes) -> np.ndarray:
    """bytes -> 0/1 array (8 bits per byte, MSB first; pn_kit.py:469-475)."""
    return np.unpackbits(np.frombuffer(byte_stream, dtype=np.uint8))
