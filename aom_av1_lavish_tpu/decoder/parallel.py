"""Parallel decode orchestration.

Re-designs the reference's decoder-side parallelism (frame-parallel
output queue in av1_dx_iface.c, tile/row workers in decodeframe.c) at
the granularity that suits this runtime: temporal units are split into
independent keyframe-delimited segments (no cross-references), and the
segments decode in a process pool.  Within a segment, decode is the
ordinary serial conformant path.
"""

from __future__ import annotations

from ..bitstream import constants as c
from ..bitstream import headers as H


def _is_keyframe_tu(payload: bytes) -> bool:
    """True when the TU starts a new prediction chain (shown keyframe)."""
    for obu_type, p in H.split_obus(payload):
        if obu_type in (c.OBU_FRAME, c.OBU_FRAME_HEADER):
            if not p:
                return False
            r0 = p[0]
            if r0 & 0x80:          # show_existing_frame
                return False
            frame_type = (r0 >> 5) & 3
            return frame_type == c.KEY_FRAME and ((r0 >> 4) & 1) == 1
    return False


def split_segments(tus) -> list:
    """Group TUs into keyframe-delimited, independently-decodable runs."""
    segments = []
    cur = []
    for tu in tus:
        if cur and _is_keyframe_tu(tu):
            segments.append(cur)
            cur = []
        cur.append(tu)
    if cur:
        segments.append(cur)
    return segments


def _decode_segment(tus):
    from .decoder import decode_frame_obus
    sh = None
    state = {"slots": [None] * 8}
    frames = []
    for tu in tus:
        fr, sh = decode_frame_obus(tu, sh, state)
        frames.extend(fr)
    return frames


def decode_ivf_parallel(path: str, workers: int = 2):
    """Frame-parallel decode of an IVF file; bit-identical to the serial
    decode_ivf.  Needs the sequence header repeated at keyframes (our
    encoders and aomenc defaults do this)."""
    from ..bitstream.ivf import read_ivf
    tus = [p for p, _ in read_ivf(path)]
    segments = split_segments(tus)
    if workers <= 1 or len(segments) <= 1:
        out = []
        for seg in segments:
            out.extend(_decode_segment(seg))
        return out
    import multiprocessing as mp
    # forkserver, not fork: the parent may hold a multithreaded JAX
    # runtime (and a GPU context) that a forked child must not inherit
    with mp.get_context("forkserver").Pool(
            min(workers, len(segments))) as pool:
        results = pool.map(_decode_segment, segments)
    out = []
    for fr in results:
        out.extend(fr)
    return out


# ---------------------------------------------------------------------------
# Within-frame tile-parallel decode (decodeframe.c:3529 decode_tiles_mt).
# Tiles are fully independent for parse + prediction (availability is
# tile-scoped), so each tile decodes in a forked worker against the
# shared pre-tile frame state; the parent merges each tile's owned
# region of every mutated array, then runs the in-loop filters as usual.
# Contract (test mirror of decode_multithreaded_test.cc): bit-identical
# to serial decode.

_TILE_DEC = None     # decoder handle inherited by forked tile workers

#: decoder arrays merged per tile, as (attr, index base offset, kind)
#: kind: "mi" = mi-indexed, "pix" = pixel planes, "half" = per-8x8
_MI_ARRAYS = ("tx_wide_grid", "tx_high_grid", "skip_inter_grid",
              "seg_map", "seg_pred_grid", "qindex_grid", "delta_lf_grid")
_MARGIN_ARRAYS = ("skip_mode_grid", "interp_grid", "tx_type_map")


def _tile_slices(dec, trow, tcol):
    """Owned index ranges of one tile in the decoder's arrays.  Last
    tiles extend to the array margins (edge-crossing transform blocks
    write recon/ctx past the mi grid only at frame edges)."""
    r0, r1 = dec.tile_row_range(trow)
    c0, c1 = dec.tile_col_range(tcol)
    last_r = r1 >= dec.mi_rows
    last_c = c1 >= dec.mi_cols
    return r0, r1, c0, c1, last_r, last_c


def _extract_tile_state(dec, trow, tcol):
    r0, r1, c0, c1, last_r, last_c = _tile_slices(dec, trow, tcol)
    m = dec.g.m
    import numpy as np
    out = {"rect": (trow, tcol)}
    sl_mi = (slice(r0, None if last_r else r1),
             slice(c0, None if last_c else c1))
    sl_m = (slice(r0 + m, None if last_r else r1 + m),
            slice(c0 + m, None if last_c else c1 + m))
    out["mi"] = dec.mi[sl_mi]
    out["g"] = tuple(getattr(dec.g, a)[sl_m] for a in
                     ("ref0", "ref1", "mode", "bsize", "partition", "mv"))
    out["mi_arrays"] = tuple(getattr(dec, a)[sl_mi] for a in _MI_ARRAYS)
    out["margin_arrays"] = tuple(getattr(dec, a)[sl_m]
                                 for a in _MARGIN_ARRAYS)
    sl_h = (slice(r0 >> 1, None if last_r else (r1 + 1) >> 1),
            slice(c0 >> 1, None if last_c else (c1 + 1) >> 1))
    out["mvs"] = (dec.frame_mvs_ref[sl_h], dec.frame_mvs[sl_h])
    pix = []
    for p, plane in enumerate(dec.planes):
        ss_x = dec.ss_x if p else 0
        ss_y = dec.ss_y if p else 0
        sl_p = (slice((r0 * 4) >> ss_y,
                      None if last_r else (r1 * 4) >> ss_y),
                slice((c0 * 4) >> ss_x,
                      None if last_c else (c1 * 4) >> ss_x))
        pix.append(plane[sl_p])
    out["pix"] = pix
    # LR units read by this tile (identical-to-default entries merge as
    # no-ops, so collecting non-default ones is sufficient)
    from ..common.restoration import RESTORE_NONE
    lr = []
    if dec.lr is not None:
        for p, pr in enumerate(dec.lr):
            for idx, ui in enumerate(pr.unit_info):
                if ui != (RESTORE_NONE, None):
                    lr.append((p, idx, ui))
    out["lr"] = lr
    out["fc"] = dec._last_ts.fc if dec._last_ts is not None else dec.fc0
    return out


def _merge_tile_state(dec, st):
    trow, tcol = st["rect"]
    r0, r1, c0, c1, last_r, last_c = _tile_slices(dec, trow, tcol)
    m = dec.g.m
    sl_mi = (slice(r0, None if last_r else r1),
             slice(c0, None if last_c else c1))
    sl_m = (slice(r0 + m, None if last_r else r1 + m),
            slice(c0 + m, None if last_c else c1 + m))
    dec.mi[sl_mi] = st["mi"]
    for a, v in zip(("ref0", "ref1", "mode", "bsize", "partition", "mv"),
                    st["g"]):
        getattr(dec.g, a)[sl_m] = v
    for a, v in zip(_MI_ARRAYS, st["mi_arrays"]):
        getattr(dec, a)[sl_mi] = v
    for a, v in zip(_MARGIN_ARRAYS, st["margin_arrays"]):
        getattr(dec, a)[sl_m] = v
    sl_h = (slice(r0 >> 1, None if last_r else (r1 + 1) >> 1),
            slice(c0 >> 1, None if last_c else (c1 + 1) >> 1))
    dec.frame_mvs_ref[sl_h] = st["mvs"][0]
    dec.frame_mvs[sl_h] = st["mvs"][1]
    for p, plane in enumerate(dec.planes):
        ss_x = dec.ss_x if p else 0
        ss_y = dec.ss_y if p else 0
        sl_p = (slice((r0 * 4) >> ss_y,
                      None if last_r else (r1 * 4) >> ss_y),
                slice((c0 * 4) >> ss_x,
                      None if last_c else (c1 * 4) >> ss_x))
        plane[sl_p] = st["pix"][p]
    for (p, idx, ui) in st["lr"]:
        dec.lr[p].unit_info[idx] = ui


def _tile_worker(args):
    tn, tile_data = args
    dec = _TILE_DEC
    # uniform-spacing tile count (spec 5.9.15), not 1 << log2
    sbs = dec.fh.sb_cols(dec.sh)
    size_sb = (sbs + (1 << dec.fh.tile_cols_log2) - 1) \
        >> dec.fh.tile_cols_log2
    trow, tcol = divmod(tn, -(-sbs // size_sb))
    dec.decode_tile_data(tile_data, trow, tcol)
    return tn, _extract_tile_state(dec, trow, tcol)


def decode_tiles_mt(dec, tiles, workers: int):
    """Decode (tile_num, data) pairs in a forked pool against `dec`,
    merging each tile's state back; returns {tile_num: end fc}."""
    global _TILE_DEC
    import multiprocessing as mp
    _TILE_DEC = dec
    try:
        with mp.get_context("fork").Pool(
                min(workers, len(tiles))) as pool:
            results = pool.map(_tile_worker, tiles)
    finally:
        _TILE_DEC = None
    fcs = {}
    for tn, st in sorted(results):
        _merge_tile_state(dec, st)
        fcs[tn] = st["fc"]
    return fcs
