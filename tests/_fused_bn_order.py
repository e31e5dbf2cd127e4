"""The order in which the port's K1c/K1d kernel (``csrc/fused_bn.cu``)
adds ds and db, emulated with numpy.  Shared by the CPU tests, which
hold it to the plain backward's sums, and the card tests, which hold
the kernel's bits to it."""

import numpy as np

from theanompi_tpu_torch.ops import fused_bn


def emulate_bwd_sums(gm, xf, geo):
    """ds and db as the K1c/K1d kernel adds them, in f32 with one
    rounding an add: each thread over its rows in order (its block's
    tiles, dealt grid-stride, then its BWD_UNROLL rows), the block's row
    groups in the pairwise tree, the cluster's blocks in rank order, then
    the clusters: split ``final_split`` ways (cluster rows j, j +
    final_split, ... in order) and the parts added pairwise.  ``gm`` is
    the masked gradient g', ``xf`` x, both f32."""
    rows, c = gm.shape
    groups, blocks, tr = geo["groups"], geo["row_blocks"], geo["tile_rows"]
    acc_s = np.zeros((blocks, groups, c), np.float32)
    acc_b = np.zeros_like(acc_s)
    span = blocks * tr        # rows the grid takes in one round of tiles
    for r0 in range(0, rows, span):
        g_it = np.zeros((span, c), np.float32)
        x_it = np.zeros((span, c), np.float32)
        g_it[:rows - r0] = gm[r0:r0 + span]
        x_it[:rows - r0] = xf[r0:r0 + span]
        # row r0 + (b * BWD_UNROLL + u) * groups + grp: block b, step u
        p = (g_it * x_it).reshape(blocks, fused_bn.BWD_UNROLL, groups, c)
        g4 = g_it.reshape(blocks, fused_bn.BWD_UNROLL, groups, c)
        for u in range(fused_bn.BWD_UNROLL):
            acc_s += p[:, u]
            acc_b += g4[:, u]
    out = []
    for acc in (acc_s, acc_b):
        m = groups
        while m > 1:
            half = (m + 1) // 2
            acc[:, :m - half] += acc[:, half:m]
            m = half
        members = acc[:, 0].reshape(geo["clusters"], geo["cluster"], c)
        per_cluster = np.zeros((geo["clusters"], c), np.float32)
        for p in range(geo["cluster"]):
            per_cluster += members[:, p]
        split = geo["final_split"]
        parts = np.zeros((split, c), np.float32)
        for j in range(split):
            for k in range(j, geo["clusters"], split):
                parts[j] += per_cluster[k]
        half = split // 2
        while half >= 1:
            parts[:half] += parts[half:2 * half]
            half //= 2
        out.append(parts[0])
    return out
