"""Host-side sizes of the weight-gradient product both backward kernels
share (csrc/tf32_mma.cuh::wgrad_tf32_kernel: one split-K 3xTF32 product per
layer over the rows of its input and gradient): the split count, which the
wrappers need to size the products' scratch. The constants mirror the
header's."""

from __future__ import annotations

WGRAD_TILE = 64                 # kWBM = kWBN: a block's output tile
WGRAD_K = 32                    # kWK: rows per pipeline stage
WGRAD_MIN_ROWS = 256            # kWMinSplitRows: rows per split, at least
WGRAD_BLOCKS = 8 * 132          # kWTargetBlocks: blocks per product, about


def wgrad_splits(rows: int, cin: int, cout: int) -> int:
    """The split count of a cin x cout product over `rows` rows, as
    tf32_mma.cuh::wgrad_splits chooses it: enough that tiles times splits
    fill the card several times over, none with fewer than WGRAD_MIN_ROWS
    rows, each a whole number of WGRAD_K-row stages."""
    tiles = -(-cin // WGRAD_TILE) * -(-cout // WGRAD_TILE)
    splits = min(-(-WGRAD_BLOCKS // tiles), max(1, rows // WGRAD_MIN_ROWS))
    chunk = -(-(-(-rows // splits)) // WGRAD_K) * WGRAD_K
    return -(-rows // chunk)


def wgrad_part_floats(products) -> int:
    """Floats of the scratch the largest of the products (rows, cin, cout)
    needs: its splits' partial products and three column sums per output."""
    return max(wgrad_splits(r, a, b) * (a + 3) * b for r, a, b in products)
