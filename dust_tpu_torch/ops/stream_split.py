"""The column split of the streamed GMM prior score (K12, d <= 8) and the
fused SVGD step (K13): `csrc/stream_split.cuh` walks the columns in
these slices, and `ops/_build.py` passes the constants below to `nvcc`,
so the kernels and the bf16 plain version (`ops/gmm.py`) share them.

A row tile is owned by a thread-block cluster of `cluster` blocks of
SLICE_WARPS warps each; warp w of the block with cluster rank b walks the
columns [s * width, min(k, (s + 1) * width)), s = b * SLICE_WARPS + w, in
tiles of TILE_COLS columns, rescaling its online softmax once per tile.
"""

from __future__ import annotations

TILE_COLS = 16       # columns per online-softmax rescale
SLICE_WARPS = 8      # warps per block, each walking its own column slice
MAX_CLUSTER = 8      # blocks per cluster (the portable limit)
MIN_SLICE = 32       # columns per slice below which the cluster shrinks


def column_split(k: int) -> tuple[int, int]:
    """(cluster, width) for k columns: the cluster is the smallest power of
    two (at most MAX_CLUSTER) whose slices hold at least MIN_SLICE columns
    each, the width the slices' column count rounded up to TILE_COLS."""
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * SLICE_WARPS * MIN_SLICE < k:
        cluster *= 2
    per = -(-k // (cluster * SLICE_WARPS))
    return cluster, -(-per // TILE_COLS) * TILE_COLS


def nvcc_defines() -> list[str]:
    """The constants as `nvcc` macro definitions."""
    return [f"-DDUST_TILE_COLS={TILE_COLS}",
            f"-DDUST_SLICE_WARPS={SLICE_WARPS}",
            f"-DDUST_MAX_CLUSTER={MAX_CLUSTER}",
            f"-DDUST_MIN_SLICE={MIN_SLICE}"]
