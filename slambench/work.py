"""The least bytes each stage's work must move at a cell's shapes, and the
card's peak: the yardstick of ``kernels_roofline``.

Each input is read once and each output written once, whatever a kernel
reads again.  The counts are of the work, not of the kernels that do it,
so a later kernel is read against the same work.  Where a count depends on
the data (the blocks fused, the blocks the raycast's hits lie in) it is the
plain reference's on the run's sampled frames.
"""

from __future__ import annotations

#: NVIDIA H100 SXM HBM3 bandwidth (data sheet), bytes/s
PEAK_BYTES_S = 3.35e12

F32, I32, U8 = 4, 4, 1


def frame_bytes(cell, frame: int, integrated: bool, rendered: bool,
                fused_blocks: float, hit_blocks: float,
                bilateral: bool, nodes: float = 0.0) -> float:
    """The least bytes frame ``frame`` moves: the upload and metric depth,
    the filter, the pyramid, ICP (each level's inputs and the reference
    maps once, the status image once), on an integrating frame the
    allocation (the depth and the block index) and the fusion (the fused
    blocks' two channels read and written), the raycast (the field of the
    blocks its hits lie in, the vertex and normal maps written) and on a
    rendering frame the three images from their inputs.  An OFusion
    frame's allocation also reads and writes the octant masks of every
    level, and its fusion the two channels of the ``nodes`` node cells it
    updates."""
    H, W = cell.H, cell.W
    px = H * W
    b = px * (I32 + F32)
    if bilateral:
        b += px * 2 * F32
    for level in range(len(cell.system.pyramid)):
        lp = px >> (2 * level)
        b += lp * (F32 + 6 * F32)            # depth, vertex, normal written
        b += lp * 6 * F32                    # ICP reads them
    b += px * 6 * F32 + px * I32             # reference maps, status image
    if integrated:
        B3 = (cell.size // 8) ** 3
        b += px * F32 + B3 * I32 * 2         # depth; block index r/w
        b += fused_blocks * 512 * 2 * F32 * 2
        if cell.system.field_type == "ofusion":
            levels = (cell.size // 8).bit_length()
            b += sum(8 ** l for l in range(levels)) * U8 * 2
            b += nodes * 2 * F32 * 2
    if frame >= cell.system.raycast_from_frame:
        b += hit_blocks * 512 * F32 + px * 6 * F32
    if rendered:
        b += px * (F32 + I32 + 6 * F32) + 3 * px * 4 * U8
    return float(b)
