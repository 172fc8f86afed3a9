"""Routing and sizing constants of the port's kernels, derived from
Hopper's limits (H100: 32-lane warps, 227 KB of shared memory a block of
which 48 KB without an opt-in, 50 MB of L2).  None of the reference's
VMEM constants (``repro/kernels/common.py``) carries over: the TPU split
between a VMEM-resident table and a streamed one does not exist here,
because the per-member edge tables are read from device memory or L2
either way.
"""
from __future__ import annotations

#: Threads in a warp, the unit the ``table`` gain kernel assigns to one
#: (member, vertex) row.
WARP_LANES = 32

#: Largest k routed to the ``table`` gain kernel.  One warp owns one
#: (member, vertex) row with its lanes over the k columns: at
#: k <= WARP_LANES every lane holds exactly one column and the row is
#: done in one pass over the vertex's incident edges.  Above it a lane
#: would walk several columns, each pass re-reading the edge ids, while
#: the ``stream`` kernel spreads a vertex tile's (vertex, column) pairs
#: over a whole block and reads the edge ids once from shared memory.
GAIN_WARP_MAX_K = WARP_LANES

#: Threads of one ``table`` or ``stream`` gain block (8 warps).
GAIN_BLOCK_THREADS = 256

#: Vertices per ``stream`` block.  With k >= 33 a tile of 8 vertices
#: gives each of the 256 threads >= 1 (vertex, column) pair.
GAIN_TILE_VERTICES = 8

#: Shared memory a ``stream`` block may use for its staged edge-id rows
#: (tile * D int32) and per-vertex losses (tile f32): the 48 KB a block
#: gets without ``cudaFuncAttributeMaxDynamicSharedMemorySize``.  The
#: wrapper shrinks the tile for wide incidence rows (D > 1535).
GAIN_TILE_SMEM_BYTES = 48 * 1024

#: Largest k for which the non-kernel fallback (CPU tensors, or a level
#: without the dense incidence layout) uses the per-pin segment-sum,
#: whose [alpha, P, k] intermediate grows with k; above it the compact
#: path scatters at most two columns per pin, O(P).
SEGSUM_MAX_K = 32

#: Candidates one thread of the rating kernel reduces in order per
#: level.  Each level leaves at most two open partial sums per chunk, so
#: a level shrinks the problem 16-fold and C = 2**20 candidates take 5
#: launches.  The rating kernel is linear in C, so every device
#: coarsening round is routed to it (no size cut-off, unlike the
#: reference's quadratic one-hot kernel).
RATING_CHUNK = 32

#: Threads of one rating block.
RATING_BLOCK_THREADS = 256

