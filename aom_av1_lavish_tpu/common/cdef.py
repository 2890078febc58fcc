"""CDEF: constrained directional enhancement filter (AV1 spec 7.15).

Reference behavior: av1/common/cdef.c (av1_cdef_frame orchestration,
8x8 skip list), cdef_block.c (cdef_find_dir_c:57, adjust_strength:289,
cdef_filter_block_internal:139), cdef.h constrain:61.

Implementation strategy: instead of the reference's line/column buffers
(which exist so in-place filtering still reads pre-CDEF neighbors), we
filter from a pristine copy of the deblocked frame into the output, which
is equivalent.  Frame borders read CDEF_VERY_LARGE.
"""

from __future__ import annotations

import numpy as np

CDEF_VERY_LARGE = 0x4000
CDEF_SEC_STRENGTHS = 4

# tap offsets (row, col) per direction (cdef_block.c:25, stride-free form)
_DIRS = [
    [(-1, 1), (-2, 2)], [(0, 1), (-1, 2)], [(0, 1), (0, 2)],
    [(0, 1), (1, 2)], [(1, 1), (2, 2)], [(1, 0), (2, 1)],
    [(1, 0), (2, 0)], [(1, 0), (2, -1)],
]
_PRI_TAPS = [[4, 2], [3, 3]]
_SEC_TAPS = [2, 1]

_DIV_TABLE = [0, 840, 420, 280, 210, 168, 140, 120, 105]

# 8 directional projection index maps (cdef_find_dir_c:68)
_PARTIAL_IDX = None


def _partial_maps():
    global _PARTIAL_IDX
    if _PARTIAL_IDX is None:
        maps = np.zeros((8, 15, 64), np.int32)
        for i in range(8):
            for j in range(8):
                p = i * 8 + j
                maps[0, i + j, p] = 1
                maps[1, i + j // 2, p] = 1
                maps[2, i, p] = 1
                maps[3, 3 + i - j // 2, p] = 1
                maps[4, 7 + i - j, p] = 1
                maps[5, 3 - i // 2 + j, p] = 1
                maps[6, j, p] = 1
                maps[7, i // 2 + j, p] = 1
        _PARTIAL_IDX = maps
    return _PARTIAL_IDX


def find_dir_blocks(blocks: np.ndarray, coeff_shift: int = 0):
    """blocks (N, 8, 8) -> (dirs (N,), variances (N,))."""
    maps = _partial_maps()
    x = (blocks.reshape(-1, 64).astype(np.int64) >> coeff_shift) - 128
    partial = np.einsum("np,fkp->nfk", x, maps)  # (N, 8, 15)
    div = np.array(_DIV_TABLE, np.int64)
    cost = np.zeros((x.shape[0], 8), np.int64)
    cost[:, 2] = (partial[:, 2, :8] ** 2).sum(-1) * div[8]
    cost[:, 6] = (partial[:, 6, :8] ** 2).sum(-1) * div[8]
    for i in range(7):
        cost[:, 0] += (partial[:, 0, i] ** 2
                       + partial[:, 0, 14 - i] ** 2) * div[i + 1]
        cost[:, 4] += (partial[:, 4, i] ** 2
                       + partial[:, 4, 14 - i] ** 2) * div[i + 1]
    cost[:, 0] += partial[:, 0, 7] ** 2 * div[8]
    cost[:, 4] += partial[:, 4, 7] ** 2 * div[8]
    for i in (1, 3, 5, 7):
        cost[:, i] = (partial[:, i, 3:8] ** 2).sum(-1) * div[8]
        for j in range(3):
            cost[:, i] += (partial[:, i, j] ** 2
                           + partial[:, i, 10 - j] ** 2) * div[2 * j + 2]
    # ties resolve to the first maximum with a strict > scan from dir 0;
    # np.argmax picks the first maximum, matching `cost[i] > best_cost`
    best = np.argmax(cost, 1)
    var = cost[np.arange(len(best)), best] \
        - cost[np.arange(len(best)), (best + 4) & 7]
    return best.astype(np.int32), (var >> 10).astype(np.int64)


def _get_msb(v: int) -> int:
    return max(0, int(v).bit_length() - 1)


def adjust_strength(strength: int, var: int) -> int:
    if var == 0:
        return 0
    i = min(_get_msb(var >> 6), 12) if (var >> 6) else 0
    return (strength * (4 + i) + 8) >> 4


def _constrain(diff, threshold, damping):
    """Vectorized constrain (cdef.h:61); threshold is a scalar > 0."""
    shift = max(0, damping - _get_msb(threshold))
    ad = np.abs(diff)
    return np.sign(diff) * np.minimum(ad,
                                      np.maximum(0, threshold - (ad >> shift)))


def filter_block(inb: np.ndarray, pri_strength: int, sec_strength: int,
                 direction: int, pri_damping: int, sec_damping: int,
                 bw: int, bh: int, coeff_shift: int = 0) -> np.ndarray:
    """Filter one block.  inb: (bh+4, bw+4) int32 source with the block at
    [2:2+bh, 2:2+bw] (taps reach +-2); returns (bh, bw) int32."""
    enable_p = pri_strength != 0
    enable_s = sec_strength != 0
    x = inb[2:2 + bh, 2:2 + bw]
    if not enable_p and not enable_s:
        return x.copy()
    clip = enable_p and enable_s
    total = np.zeros((bh, bw), np.int64)
    mx = x.copy()
    mn = x.copy()

    def tap(dr, dc):
        return inb[2 + dr:2 + dr + bh, 2 + dc:2 + dc + bw]

    # tap parity from the unshifted strength (cdef_block.c:147)
    pri_taps = _PRI_TAPS[(pri_strength >> coeff_shift) & 1]
    for k in range(2):
        if enable_p:
            dr, dc = _DIRS[direction][k]
            for s in (1, -1):
                p = tap(s * dr, s * dc)
                total += pri_taps[k] * _constrain(p - x, pri_strength,
                                                  pri_damping)
                if clip:
                    mx = np.where(p != CDEF_VERY_LARGE, np.maximum(p, mx),
                                  mx)
                    mn = np.minimum(p, mn)
        if enable_s:
            # dir +-2 wraps through the padded table, i.e. modulo 8
            for doff in (2, -2):
                dr, dc = _DIRS[(direction + doff) % 8][k]
                for s in (1, -1):
                    p = tap(s * dr, s * dc)
                    if clip:
                        mx = np.where(p != CDEF_VERY_LARGE,
                                      np.maximum(p, mx), mx)
                        mn = np.minimum(p, mn)
                    total += _SEC_TAPS[k] * _constrain(p - x, sec_strength,
                                                       sec_damping)
    y = x + ((8 + total - (total < 0)) >> 4)
    if clip:
        y = np.clip(y, mn, mx)
    return y.astype(np.int32)


def _msb_capped(v, cap: int):
    """min(floor(log2(v)), cap) per element for v > 0, and 0 for v == 0."""
    return sum(((v >> b) > 0).astype(np.int64) for b in range(1, cap + 1))


def _filter_blocks(win, pri, sec, direction, damping: int, bw: int,
                   bh: int, coeff_shift: int):
    """filter_block over N blocks at once: win (N, bh+4, bw+4) int32;
    pri/sec/direction (N,) per-block strengths and directions.  Every
    branch of filter_block becomes a per-block mask."""
    N = win.shape[0]
    n = np.arange(N)[:, None, None]
    ii = np.arange(bh)[None, :, None]
    jj = np.arange(bw)[None, None, :]
    x = win[:, 2:2 + bh, 2:2 + bw].astype(np.int64)
    en_p = (pri != 0)[:, None, None]
    en_s = (sec != 0)[:, None, None]
    total = np.zeros((N, bh, bw), np.int64)
    mx = x.copy()
    mn = x.copy()
    dirs = np.asarray(_DIRS, np.int64)                       # (8, 2, 2)
    pri_taps = np.asarray(_PRI_TAPS, np.int64)[(pri >> coeff_shift) & 1]

    def constrain(diff, threshold):
        shift = np.maximum(0, damping - _msb_capped(threshold, 15))
        ad = np.abs(diff)
        lim = np.maximum(0, threshold[:, None, None]
                         - (ad >> shift[:, None, None]))
        return np.sign(diff) * np.minimum(ad, lim)

    def tap(d, k, s):
        p = win[n, 2 + s * dirs[d, k, 0][:, None, None] + ii,
                2 + s * dirs[d, k, 1][:, None, None] + jj].astype(np.int64)
        nonlocal mx, mn
        mx = np.where(p != CDEF_VERY_LARGE, np.maximum(p, mx), mx)
        mn = np.minimum(p, mn)
        return p

    for k in range(2):
        for s in (1, -1):
            p = tap(direction, k, s)
            total += np.where(en_p, pri_taps[:, k, None, None]
                              * constrain(p - x, pri), 0)
            for doff in (2, -2):
                p = tap((direction + doff) % 8, k, s)
                total += np.where(en_s, _SEC_TAPS[k] * constrain(p - x, sec),
                                  0)
    y = x + ((8 + total - (total < 0)) >> 4)
    return np.where(en_p & en_s, np.clip(y, mn, mx), y)


def cdef_frame(planes, mi_rows, mi_cols, ss_x, ss_y, num_planes,
               skip_grid, strength_grid, fh, bd=8):
    """Apply CDEF in place over mi-aligned planes.

    skip_grid: (mi_rows, mi_cols) skip_txfm per mi; strength_grid:
    per-64x64 cdef_strength index (-1 = not coded); fh carries the parsed
    cdef_* frame parameters.  All 8x8 blocks of the frame filter as one
    batch (_filter_blocks); filter_block is the per-block reference."""
    coeff_shift = bd - 8
    w = mi_cols * 4
    h = mi_rows * 4
    pristine = []
    for p in range(num_planes):
        sx = ss_x if p else 0
        sy = ss_y if p else 0
        buf = np.full(((h >> sy) + 8, (w >> sx) + 8), CDEF_VERY_LARGE,
                      np.int32)
        buf[4:4 + (h >> sy), 4:4 + (w >> sx)] = \
            planes[p][:h >> sy, :w >> sx]
        pristine.append(buf)

    def per_sidx(vals, bump):
        v = np.asarray(vals, np.int64)
        return v + (v == 3) if bump else v

    y_pri = per_sidx(fh.cdef_y_pri, False)
    y_sec = per_sidx(fh.cdef_y_sec, True)
    uv_pri = per_sidx(fh.cdef_uv_pri, False) if num_planes > 1 else \
        np.zeros_like(y_pri)
    uv_sec = per_sidx(fh.cdef_uv_sec, True) if num_planes > 1 else \
        np.zeros_like(y_sec)

    # 8x8 blocks: the skip list (an 8x8 filters unless all of its mi skip)
    # and the 64x64 strength index each block falls in
    r8, c8 = (mi_rows + 1) // 2, (mi_cols + 1) // 2
    sk = np.ones((2 * r8, 2 * c8), bool)
    sk[:mi_rows, :mi_cols] = np.asarray(skip_grid[:mi_rows, :mi_cols],
                                        bool)
    skip8 = sk.reshape(r8, 2, c8, 2).all((1, 3))
    by8, bx8 = np.meshgrid(np.arange(r8), np.arange(c8), indexing="ij")
    sidx = np.asarray(strength_grid)[by8 // 8, bx8 // 8]
    si = np.maximum(sidx, 0)
    live = ((sidx >= 0) & ~skip8
            & ((y_pri[si] | y_sec[si] | uv_pri[si] | uv_sec[si]) != 0))
    by8, bx8, si = by8[live], bx8[live], si[live]
    if by8.size == 0:
        return
    # directions from luma
    y8 = pristine[0][4 + 8 * by8[:, None, None] + np.arange(8)[:, None],
                     4 + 8 * bx8[:, None, None] + np.arange(8)]
    dirs, variances = find_dir_blocks(y8, coeff_shift)
    if num_planes > 1 and ss_x != ss_y:
        # 4:2:2 / 4:4:0 chroma: directions remap to the
        # subsampled geometry (cdef_block.c:361 conv422/conv440)
        conv = (np.array([7, 0, 2, 4, 5, 6, 6, 6]) if ss_x
                else np.array([1, 2, 2, 2, 3, 4, 6, 0]))
        chroma_dirs = conv[dirs]
    else:
        chroma_dirs = dirs

    for plane in range(num_planes):
        sx = ss_x if plane else 0
        sy = ss_y if plane else 0
        lvl = (y_pri if plane == 0 else uv_pri)[si]
        sec = (y_sec if plane == 0 else uv_sec)[si]
        pri_strength = lvl << coeff_shift
        sec_strength = sec << coeff_shift
        if plane == 0:
            # adjust_strength, per block
            i = _msb_capped(variances >> 6, 12)
            t = np.where(variances == 0, 0,
                         (pri_strength * (4 + i) + 8) >> 4)
        else:
            t = pri_strength
        go = (t != 0) | (sec_strength != 0)
        if not go.any():
            continue
        d = np.where(pri_strength != 0,
                     dirs if plane == 0 else chroma_dirs, 0)[go]
        dmp = fh.cdef_damping + coeff_shift - (1 if plane else 0)
        bw = 8 >> sx
        bh = 8 >> sy
        py = (8 * by8[go]) >> sy
        px = (8 * bx8[go]) >> sx
        rows = 4 + py[:, None, None] - 2 + np.arange(bh + 4)[:, None]
        cols = 4 + px[:, None, None] - 2 + np.arange(bw + 4)
        win = pristine[plane][rows, cols]
        out = _filter_blocks(win, t[go], sec_strength[go], d, dmp, bw, bh,
                             coeff_shift)
        planes[plane][py[:, None, None] + np.arange(bh)[:, None],
                      px[:, None, None] + np.arange(bw)] = \
            np.clip(out, 0, (1 << bd) - 1).astype(planes[plane].dtype)
