"""Routing and sizing constants of the port's kernels, derived from
Hopper's limits (H100 SXM: 132 SMs of 2,048 resident threads and 65,536
registers each, 32-lane warps, 227 KB of shared memory a block of which
48 KB without an opt-in, 50 MB of L2).  None of the reference's
VMEM constants (``repro/kernels/common.py``) carries over: the TPU split
between a VMEM-resident table and a streamed one does not exist here,
because the per-member edge tables are read from device memory or L2
either way.
"""
from __future__ import annotations

#: Threads in a warp, the most lanes the gain kernel gives one
#: (member, vertex) row.
WARP_LANES = 32

#: Streaming multiprocessors of the H100 SXM, and the threads one of them
#: keeps resident.
H100_SMS = 132
SM_THREADS = 2048

#: Largest k routed to the ``table`` entry of the gain kernel, ``stream``
#: above it.  On the card both entries launch the one kernel of
#: ``csrc/gain.cu``: a group of G lanes a row, 4 columns a lane where k
#: and the alignment allow, G the smallest power of two that covers k in
#: one pass (k 16: 4 lanes, 8 rows a warp; k 32: 8 lanes; above 128
#: columns, 32 lanes in several passes).  So the split no longer changes
#: what the card runs; it keeps the reference's two entries, their
#: launch counts and their plain versions (the ``table`` one gathers
#: [alpha, N, D, k] at once, the ``stream`` one sweeps edge tiles).  It
#: stays at WARP_LANES: k <= 32 is the widest at which one warp holds a
#: row in one pass at one column a lane, the reference's ``table`` width.
GAIN_WARP_MAX_K = WARP_LANES

#: Threads of one gain block (8 warps).
GAIN_BLOCK_THREADS = 256

#: Largest k for which the non-kernel fallback (CPU tensors, or a level
#: without the dense incidence layout) uses the per-pin segment-sum,
#: whose [alpha, P, k] intermediate grows with k; above it the compact
#: path scatters at most two columns per pin, O(P).
SEGSUM_MAX_K = 32

#: Candidates of one tile of the rating kernel's first pass: a block of
#: 8 warps whose lanes own 4 consecutive candidates each (one 16-byte
#: load of ids and of each row's values), so 1,024.  The block adds the
#: parts of a segment across its warps through 8 words of shared memory
#: a row and one barrier; a segment that crosses tiles leaves one piece
#: per tile to the second pass, which reads 512 pieces a step: the ghost
#: pairs' run, 87% of C = 2^20 at ibm08, takes it 2 steps.  The kernel
#: checks that it is given this value (``csrc/rating.cu``'s ``TILE``).
#: The rating kernel is linear in C, so every device coarsening round is
#: routed to it (no size cut-off, unlike the reference's quadratic
#: one-hot kernel).
RATING_TILE = 1024

#: The most rows of ``vals`` one first-pass block sums (the kernel takes
#: fewer when there are fewer rows).  The starts and the scan's shape are
#: found once per tile and reused for these rows, and the rows' loads go
#: out together.  4 rows of 4 values keep a thread within the 64
#: registers that let 4 blocks of 256 threads share an SM: the FM step's
#: shape (119 rows of 16,384 pins) is 17 tiles x 30 row groups = 510
#: blocks, about one wave on the H100's 132 SMs.
RATING_ROWS = 4

#: Largest k the connectivity and cut kernels take: they OR one bit per
#: block into a uint32 mask per edge and count its bits with ``__popc``,
#: so k is bounded by the mask's 32 bits.  ``ops.connectivity`` and
#: ``ops.cutsize`` route larger k to the plain versions, as the
#: reference's ops do.
KERNEL_MAX_K = 32

#: Threads of one connectivity or cut block (8 warps; ``kThreads`` in
#: ``csrc/connectivity.cu``).
CONN_BLOCK_THREADS = 256

#: Blocks of the connectivity and cut kernels one SM keeps resident:
#: 2,048 / 256 = 8.  The kernels' ``__launch_bounds__(256, 8)`` hold them
#: to 65,536 / 2,048 = 32 registers a thread, so all 8 fit (``kMinBlocks``).
CONN_BLOCKS_PER_SM = SM_THREADS // CONN_BLOCK_THREADS

#: Rows a lane group of the connectivity and cut kernels takes a step,
#: all their pin loads issued before the first gather (``kRows``).
CONN_ROWS = 2

#: One resident wave of the connectivity and cut kernels (132 x 8 =
#: 1,056 blocks): the most blocks they launch, and the cut's partials.
CONN_WAVE_BLOCKS = H100_SMS * CONN_BLOCKS_PER_SM


def conn_lanes(s: int) -> int:
    """Lanes of the group that owns a pin row of S slots on the kernels'
    16-byte path: the smallest power of two covering S / 4 ids, at most a
    warp (S = 8: 2, S = 64: 16, S >= 128: 32)."""
    g = 1
    while g < WARP_LANES and 4 * g < s:
        g *= 2
    return g


def conn_grid(m: int, s: int) -> int:
    """Blocks of the connectivity and cut kernels for pins [M, S]: one
    per ``CONN_BLOCK_THREADS / conn_lanes(S) * CONN_ROWS`` rows, at most
    one resident wave, a grid-stride loop beyond it (ibm08's 50,688 x 64:
    1,584 wanted, 1,056 launched).  A function of (M, S) alone, so the
    cut adds in the same order on every launch; the one-id path (S not a
    multiple of 4, or pins off the 16-byte alignment) takes the same grid
    with wider groups and more steps."""
    rows = CONN_BLOCK_THREADS // conn_lanes(s) * CONN_ROWS
    return max(1, min(-(-m // rows), CONN_WAVE_BLOCKS))
