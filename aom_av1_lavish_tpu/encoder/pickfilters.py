"""Encoder-side in-loop filter parameter search.

Re-design of the reference's filter pickers:
  * deblocking level search — av1/encoder/picklpf.c
    (av1_pick_filter_level): candidate levels around the q-derived
    guess, scored by frame SSE against the source;
  * CDEF strength search — av1/encoder/pickcdef.c:839 av1_cdef_search:
    frame-level (cdef_bits=0) search over primary/secondary strength
    pairs, scored by SSE.  A single strength pair needs no per-block
    cdef_idx symbols, so the search is a pure header + recon decision.

Both searches run on the reconstructed frame the encoder already holds;
the chosen parameters are written into the frame header (which is
serialized after tile encode) and applied to recon so reference frames
match the decoder bit-exactly.
"""

from __future__ import annotations

import numpy as np

from ..common import cdef as CD
from ..common import loopfilter as LF


def _sse(a, b) -> float:
    d = a.astype(np.int64) - b.astype(np.int64)
    return float((d * d).sum())


def pick_filter_level(src_planes, recon_planes, fh, sh, lf_apply) -> int:
    """Search the luma deblock level; returns the chosen level and sets
    fh.filter_level / _u / _v.

    lf_apply(planes, level): applies deblocking in place at that level
    (the encoder provides a closure over its mi grids)."""
    base = fh.filter_level[0] or LF.pick_filter_level_from_q(
        fh.base_q_idx, fh.frame_type == 0, bd=sh.bit_depth)
    cands = sorted({0, max(0, base - 8), max(0, base - 4), base,
                    min(63, base + 4), min(63, base + 8)})
    h = fh.mi_rows() * 4
    w = fh.mi_cols() * 4
    best = None
    for lvl in cands:
        if lvl == 0:
            err = _sse(src_planes[0][:h, :w], recon_planes[0][:h, :w])
        else:
            trial = [p.copy() for p in recon_planes]
            lf_apply(trial, lvl)
            err = _sse(src_planes[0][:h, :w], trial[0][:h, :w])
        if best is None or err < best[0]:
            best = (err, lvl)
    lvl = best[1]
    fh.filter_level = (lvl, lvl)
    fh.filter_level_u = lvl
    fh.filter_level_v = lvl
    return lvl


# frame-level CDEF candidates: (primary, secondary) strength pairs
CDEF_CANDIDATES = ((0, 0), (1, 0), (2, 0), (4, 0), (7, 0),
                   (1, 1), (2, 2), (4, 2), (9, 0), (12, 2))


def pick_cdef(src_planes, recon_planes, mi_rows, mi_cols, ss_x, ss_y,
              num_planes, skip_grid, fh, bd=8) -> None:
    """Frame-level CDEF strength search (cdef_bits=0): applies the best
    candidate to recon in place and sets fh.cdef_*."""
    nvfb = (mi_rows + 15) // 16
    nhfb = (mi_cols + 15) // 16
    strength_grid = np.zeros((nvfb, nhfb), np.int32)
    w = mi_cols * 4
    h = mi_rows * 4

    def frame_sse(planes):
        err = 0.0
        for p in range(num_planes):
            sx = ss_x if p else 0
            sy = ss_y if p else 0
            err += _sse(src_planes[p][:h >> sy, :w >> sx],
                        planes[p][:h >> sy, :w >> sx])
        return err

    best = None
    for (pri, sec) in CDEF_CANDIDATES:
        if pri == 0 and sec == 0:
            err = frame_sse(recon_planes)
            cand_planes = None
        else:
            fh.cdef_bits = 0
            fh.cdef_y_pri = (pri,) * 8
            fh.cdef_y_sec = (sec,) * 8
            fh.cdef_uv_pri = (pri,) * 8
            fh.cdef_uv_sec = (sec,) * 8
            cand_planes = [p.copy() for p in recon_planes]
            CD.cdef_frame(cand_planes, mi_rows, mi_cols, ss_x, ss_y,
                          num_planes, skip_grid, strength_grid, fh, bd)
            err = frame_sse(cand_planes)
        if best is None or err < best[0]:
            best = (err, pri, sec, cand_planes)
    _, pri, sec, cand_planes = best
    fh.cdef_bits = 0
    fh.cdef_y_pri = (pri,) * 8
    fh.cdef_y_sec = (sec,) * 8
    fh.cdef_uv_pri = (pri,) * 8
    fh.cdef_uv_sec = (sec,) * 8
    if cand_planes is not None:
        for p, cp in zip(recon_planes, cand_planes):
            p[:] = cp
