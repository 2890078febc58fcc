"""Device-batched P-frame encoding: motion search + MC + transform coding.

Inter blocks only read the (fixed) reference frames, so unlike intra
there is no wavefront dependency at all: every 16x16 block's motion
search, motion compensation, forward transform, quantization and
reconstruction runs as ONE batched jit invocation over the whole frame.
The host then walks the fixed partition tree and feeds the entropy coder
(encoder/tpu_inter.py).

Motion search (batched redesign of av1/encoder/mcomp.c:1755
av1_full_pixel_search + mcomp.h:337 subpel tree): instead of the
reference's sequential NSTEP/diamond descent, the full-pel cost surface
is computed EXHAUSTIVELY on the device via the SSD identity
    ssd(dy,dx) = sum(src^2) + sum(ref^2)[dy,dx] - 2*corr[dy,dx]
where corr is a grouped convolution of each block against its search
window and sum(ref^2) a reduce_window — both batched over all blocks of
the frame.  A half-resolution pass doubles the radius (effective +-32),
then a two-stage half/quarter-pel refine runs through the normative
8-tap interpolator.  Multi-reference: the search runs per ref and each
block picks its best by cost.

The MC math mirrors common/interpred.py bit-exactly (verified against
the convolve oracle via the conformance tests).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..bitstream import constants as c
from ..common import interpred as IP
from ..common import quant as Q
from ..common import coeffs as CF
from ..bitstream import tables
from .txfm_jax import fwd_txfm2d_batched, inv_txfm2d_add_batched
from .wavefront import _quantize_jnp, _est_bits, _PQ, _pq_array

PADR = 64          # device ref padding (>= clamp overshoot + taps)
FULLPEL_RADIUS = 16
#: scan-order coefficient truncation for the result fetch (>p95 of
#: blocks at working q; blocks flagged in hdr col 6 — eob over the cap
#: or a coefficient outside int8 — batch-fetch their full int16 rows)
CAPY, CAPC = 64, 32
MV_COST_W = 16.0   # SSD units per full-pel step of |mv| (rate proxy)
# kept as NUMPY on purpose: numpy constants are inlined into the
# compiled HLO at trace time.
FILT8 = np.asarray(IP.SUBPEL_FILTERS_8)     # (16, 8) regular
#: frame-filter banks indexed by the header enum (EIGHTTAP_REGULAR=0,
#: EIGHTTAP_SMOOTH=1, MULTITAP_SHARP=2 — filter.h:31)
FILT_BANKS = np.stack([np.asarray(IP.SUBPEL_FILTERS_8),
                       np.asarray(IP.SUBPEL_FILTERS_8SMOOTH),
                       np.asarray(IP.SUBPEL_FILTERS_8SHARP)])


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n


def _gather_blocks(plane, base_r, base_c, h, w):
    """plane (H', W'); base_r/base_c (B,) -> (B, h, w) through
    pallas_kernels.gather_windows."""
    from .pallas_kernels import gather_windows
    return gather_windows(plane, base_r, base_c, h, w)


def _mc_block(refp, x0, y0, bw, bh, mv_r_q4, mv_c_q4, filt=None):
    """Batched single-ref convolve (av1_convolve_2d_sr family) for blocks
    of size (bh, bw) at plane coords (x0, y0) (B,), mv already clamped,
    in q4 plane units.  refp is PADR-padded; returns (B, bh, bw) uint8.
    filt: optional (16, 8) tap table (traced — the per-frame switchable
    filter bank); None = the regular trace-time constant."""
    pos_r = (y0 << 4) + mv_r_q4
    pos_c = (x0 << 4) + mv_c_q4
    fr = pos_r >> 4
    fc = pos_c >> 4
    sr = pos_r & 15
    sc = pos_c & 15
    region = _gather_blocks(refp, PADR + fr - 3, PADR + fc - 3,
                            bh + 7, bw + 7).astype(jnp.int32)
    if filt is None:
        filt = jnp.asarray(FILT8)   # trace-time constant (FILT8 note)
    kx = filt[sc]           # (B, 8)
    ky = filt[sr]
    from .pallas_kernels import convolve_8tap
    return convolve_8tap(region, kx, ky, bh, bw)


def _clamp_mv(mv_r, mv_c, bw, bh, ss_x, ss_y, x0l, y0l, fw, fh_, bw4l,
              bh4l):
    """clamp_mv_to_umv_border_sb in q4 plane units (batched).
    x0l/y0l: luma block origins (B,); fw/fh_: luma frame dims;
    bw4l/bh4l: luma block dims."""
    spel_left_c = (4 + bw) << 4
    spel_right_c = spel_left_c - 16
    spel_left_r = (4 + bh) << 4
    spel_right_r = spel_left_r - 16
    sx = 1 << (1 - ss_x)
    sy = 1 << (1 - ss_y)
    row = mv_r * sy
    col = mv_c * sx
    lo_c = (-x0l) * 8 * sx - spel_left_c
    hi_c = (fw - bw4l - x0l) * 8 * sx + spel_right_c
    lo_r = (-y0l) * 8 * sy - spel_left_r
    hi_r = (fh_ - bh4l - y0l) * 8 * sy + spel_right_r
    return (jnp.clip(row, lo_r, hi_r), jnp.clip(col, lo_c, hi_c))


def _stride_windows(refp, oy, ox, nby, nbx, bsz, wsz):
    """(B, wsz, wsz) windows at regular stride bsz over a padded plane,
    window origin = block origin + (oy, ox) — built from STATIC slices
    (wsz must be a multiple of bsz), so no data-dependent gather."""
    t = wsz // bsz
    H, W = nby * bsz, nbx * bsz
    rows = []
    for dy in range(t):
        row = [refp[oy + dy * bsz:oy + dy * bsz + H,
                    ox + dx * bsz:ox + dx * bsz + W]
               .reshape(nby, bsz, nbx, bsz) for dx in range(t)]
        rows.append(jnp.concatenate(row, axis=-1))
    win = jnp.concatenate(rows, axis=1)          # (nby, wsz, nbx, wsz)
    return win.transpose(0, 2, 1, 3).reshape(nby * nbx, wsz, wsz)


def _ssd_surface(src_blk, refp, y0, x0, bsz, radius, grid=None,
                 pad=PADR, peak=255):
    """Exhaustive full-pel SSD surface (pallas_kernels.ssd_surface).

    src_blk: (B, bsz, bsz) int; refp: plane padded by `pad`; y0/x0: (B,)
    block origins in plane coords; peak: the largest pixel value.
    grid=(nby, nbx) marks the regular-stride layout (always true in this
    module) enabling static window assembly.  Returns (B, 2r+1, 2r+1)
    float32 SSD, computed exactly in int32 (see ssd_surface for where
    float32 rounds it)."""
    W = 2 * radius + bsz
    if grid is not None and W % bsz == 0:
        nby, nbx = grid
        win = _stride_windows(refp, pad - radius, pad - radius,
                              nby, nbx, bsz, W).astype(jnp.int32)
    else:
        win = _gather_blocks(refp, pad + y0 - radius, pad + x0 - radius,
                             W, W).astype(jnp.int32)
    from .pallas_kernels import ssd_surface
    return ssd_surface(src_blk, win, bsz, radius, peak=peak)


def block_cost_volume(cur, ref, block: int, radius: int):
    """Full-pel SSD surfaces for every (block x block) tile of `cur`
    against `ref` windows of +-radius: (Hb*Wb, 2r+1, 2r+1) float32
    through the SSD identity (pallas_kernels.ssd_surface).  Shared by
    the TPL and temporal-filter motion passes (their reference counterparts run
    serial per-block searches: tpl_model.c:1369 mc_flow_dispenser,
    temporal_filter.c:1284); 2*radius + block must be a multiple of
    block for the static window assembly."""
    H, W = cur.shape
    Hb, Wb = H // block, W // block
    src_blk = cur.reshape(Hb, block, Wb, block).transpose(0, 2, 1, 3) \
        .reshape(Hb * Wb, block, block).astype(jnp.int32)
    pad = jnp.pad(ref, radius, mode="edge")
    wsz = 2 * radius + block
    assert wsz % block == 0
    win = _stride_windows(pad, 0, 0, Hb, Wb, block, wsz)
    from .pallas_kernels import ssd_surface
    return ssd_surface(src_blk, win.astype(jnp.int32), block, radius)


def _argmin2d(cost):
    """(B, H, W) -> (dy_idx, dx_idx, val) of the row-major first minimum."""
    B, H, W = cost.shape
    flat = cost.reshape(B, H * W)
    idx = jnp.argmin(flat, axis=1)
    return idx // W, idx % W, jnp.take_along_axis(
        flat, idx[:, None], axis=1)[:, 0]


def _mv_bias(dy, dx):
    return MV_COST_W * (jnp.abs(dy) + jnp.abs(dx)).astype(jnp.float32)


def _window_select(base, off_r, off_c, h, w, span):
    """Extract per-block (h, w) tiles from (B, h+span-1, w+span-1)
    windows at small dynamic offsets off_r/off_c in [0, span) — as
    one-hot blends of STATIC slices: the search loops below would
    otherwise issue dozens of data-dependent gathers."""
    rows = 0
    for k in range(span):
        sl = base[:, k:k + h, :]
        rows = rows + jnp.where((off_r == k)[:, None, None], sl, 0)
    out = 0
    for k in range(span):
        sl = rows[:, :, k:k + w]
        out = out + jnp.where((off_c == k)[:, None, None], sl, 0)
    return out


def _fullpel_search(sy_blk, refp_y, refp_y2, y0, x0, bsz, grid=None):
    """Two-scale exhaustive full-pel search for one reference.

    Returns (best_dy, best_dx, cost) in full-pel units, range ~+-32."""
    r = FULLPEL_RADIUS
    # full-res surface: +-16
    ssd0 = _ssd_surface(sy_blk, refp_y, y0, x0, bsz, r, grid=grid)
    iy0, ix0, c0 = _argmin2d(
        ssd0 + _mv_bias(jnp.arange(2 * r + 1)[None, :, None] - r,
                        jnp.arange(2 * r + 1)[None, None, :] - r))
    dy0, dx0 = iy0 - r, ix0 - r
    # half-res surface: +-16 at half res == +-32 full-res
    src_h = sy_blk.reshape(sy_blk.shape[0], bsz // 2, 2, bsz // 2, 2) \
        .sum((2, 4))
    # (the half-res plane carries PADR//2 of padding — the window origin
    # must use it, not PADR, or the long-range pass searches 64px off)
    ssd1 = _ssd_surface(src_h, refp_y2, y0 // 2, x0 // 2, bsz // 2, r,
                        grid=grid, pad=PADR // 2, peak=4 * 255)
    iy1, ix1, _ = _argmin2d(ssd1)
    dy1, dx1 = (iy1 - r) * 2, (ix1 - r) * 2
    # refine the half-res candidate at full res (3x3): ONE window
    # gather, then static-slice selection per candidate
    wy = jnp.clip(dy1, -2 * r + 1, 2 * r - 1)
    wx = jnp.clip(dx1, -2 * r + 1, 2 * r - 1)
    base = _gather_blocks(refp_y, PADR + y0 + wy - 1, PADR + x0 + wx - 1,
                          bsz + 2, bsz + 2).astype(jnp.float32)
    syf = sy_blk.astype(jnp.float32)
    cands = [(dy0, dx0, c0)]
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            ny = jnp.clip(dy1 + oy, -2 * r, 2 * r)
            nx = jnp.clip(dx1 + ox, -2 * r, 2 * r)
            blk = _window_select(base, ny - (wy - 1), nx - (wx - 1),
                                 bsz, bsz, 3)
            d = blk - syf
            cands.append((ny, nx, (d * d).sum((1, 2)) + _mv_bias(ny, nx)))
    cy = jnp.stack([t[0] for t in cands], 1)
    cx = jnp.stack([t[1] for t in cands], 1)
    cc = jnp.stack([t[2] for t in cands], 1)
    bi = jnp.argmin(cc, axis=1)
    ar = jnp.arange(cy.shape[0])
    return cy[ar, bi], cx[ar, bi], cc[ar, bi]


def _subpel_refine(sy_blk, refp_y, y0, x0, bsz, best_dy, best_dx, W, H,
                   hp=None):
    """Half-pel 3x3 then quarter-pel 3x3 around the full-pel winner,
    through the normative interpolator, then (when `hp`, a traced
    per-frame flag, is nonzero) an eighth-pel 4-point diamond —
    av1_find_best_sub_pixel_tree's precision ladder (mcomp.h:337).
    Returns (mv_r, mv_c, pred, cost): 1/8-pel MVs (even when hp=0)
    plus the winner's exact prediction.

    All candidate interpolations read from ONE gathered window per
    block (the candidates stay within +-7/8 pel of the clamped centre,
    so every integer base row/col is within +-1 of the centre's)."""
    B = sy_blk.shape[0]
    syf = sy_blk.astype(jnp.float32)
    cr0, cc0 = _clamp_mv(best_dy * 8, best_dx * 8, bsz, bsz, 0, 0,
                         x0, y0, W, H, bsz, bsz)
    fr0 = ((y0 << 4) + cr0) >> 4
    fc0 = ((x0 << 4) + cc0) >> 4
    # window covers integer bases fr0-1 .. fr0+1 and the 8-tap reach
    base = _gather_blocks(refp_y, PADR + fr0 - 4, PADR + fc0 - 4,
                          bsz + 9, bsz + 9).astype(jnp.int32)
    filt = jnp.asarray(FILT8)

    def eval_mv(mv_r, mv_c):
        cr, ccol = _clamp_mv(mv_r, mv_c, bsz, bsz, 0, 0, x0, y0, W, H,
                             bsz, bsz)
        pos_r = (y0 << 4) + cr
        pos_c = (x0 << 4) + ccol
        fr = pos_r >> 4
        fc = pos_c >> 4
        region = _window_select(base, fr - (fr0 - 1), fc - (fc0 - 1),
                                bsz + 7, bsz + 7, 3)
        from .pallas_kernels import convolve_8tap
        pred = convolve_8tap(region, filt[pos_c & 15], filt[pos_r & 15],
                             bsz, bsz)
        d = pred.astype(jnp.float32) - syf
        cost = (d * d).sum((1, 2)) + MV_COST_W / 8.0 * (
            jnp.abs(mv_r) + jnp.abs(mv_c)).astype(jnp.float32)
        return cost, pred

    mv_r = best_dy * 8
    mv_c = best_dx * 8
    best_cost = best_pred = None

    def pick(cands):
        sstack = jnp.stack([t[0] for t in cands], 1)
        rstack = jnp.stack([t[1] for t in cands], 1)
        cstack = jnp.stack([t[2] for t in cands], 1)
        pstack = jnp.stack([t[3] for t in cands], 1)
        bi = jnp.argmin(sstack, axis=1)
        ar = jnp.arange(sstack.shape[0])
        return (rstack[ar, bi], cstack[ar, bi], pstack[ar, bi],
                sstack[ar, bi])

    for step in (4, 2):
        cands = []
        for oy in (-step, 0, step):
            for ox in (-step, 0, step):
                r_ = mv_r + oy
                c_ = mv_c + ox
                cost, pred = eval_mv(r_, c_)
                cands.append((cost, r_, c_, pred))
        mv_r, mv_c, best_pred, best_cost = pick(cands)
    if hp is not None:
        # eighth-pel diamond; selected per frame (hp MVs are only legal
        # when the header signals allow_high_precision_mv)
        cands = [(best_cost, mv_r, mv_c, best_pred)]
        for (oy, ox) in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            cost, pred = eval_mv(mv_r + oy, mv_c + ox)
            cands.append((cost, mv_r + oy, mv_c + ox, pred))
        mv8_r, mv8_c, pred8, cost8 = pick(cands)
        take = (hp != 0)
        t3 = take[..., None, None] if hasattr(take, "ndim") and \
            take.ndim else take
        mv_r = jnp.where(take, mv8_r, mv_r)
        mv_c = jnp.where(take, mv8_c, mv_c)
        best_pred = jnp.where(t3, pred8, best_pred)
        best_cost = jnp.where(take, cost8, best_cost)
    return mv_r, mv_c, best_pred, best_cost


_FN_CACHE = {}

#: per-leaf mode/MV overhead estimates (bits) driving the partition
#: merge DP, and the per-split partition-symbol rate.  These stand in
#: for the reference's exact mode-rate accounting inside
#: av1_rd_pick_partition (partition_search.c:5310): a 16x16 leaf costs
#: ~a skip flag + inter mode + MV residual; merging 4 leaves into one
#: 32x32 saves ~3 of those.
OH16, OH32, OH64 = 8.0, 9.0, 10.0
R_SPLIT = 1.0
#: coefficient-fetch truncation caps for the merged levels (int8 scan
#: prefix shipped; flagged blocks batch-fetch their full int16 rows)
CAPY32, CAPC32 = 96, 48
CAPY64, CAPC64 = 128, 64


def _lower_median4(x):
    """(B, 4) -> (B,) lower median (an actual member of the set, so the
    result is a realizable MV)."""
    return jnp.sort(x, axis=1)[:, 1]


#: pixel-SSE per dq^2 of one coefficient (measured through the exact
#: integer inverse transforms; orthogonal bases make it per-tx-size
#: constant).  Keys: TX_8X8, TX_16X16, TX_32X32, TX_64X64.
_TX_SSE_K = {1: 0.0163, 2: 0.0182, 3: 0.0734, 4: 0.2914}


def _rd_dropout(qc, dqc, scan, inv_scan, lam, tx_size, rbits=1.0):
    """Trellis-lite tail dropout (the dropout mode of av1_optimize_txb,
    av1/encoder/txb_rdopt.c / encodemb.h:40): cut the scan tail at the
    position minimizing suffix RD.  Each kept coefficient costs its
    base/sign bits PLUS the zero run back to the previous nonzero
    (the est_bits 0.55/coeff run term); dropping the tail from i saves
    those bits and adds K*dq^2 pixel distortion per dropped nonzero —
    the cut lands where the suffix sum of (distortion - lam*bits) is
    most negative.  qc/dqc are raster-flat; scan/inv_scan numpy
    closure constants."""
    import os
    if os.environ.get("AVL_NO_DROPOUT"):
        return qc, dqc
    K = _TX_SSE_K.get(int(tx_size), 0.02)
    qs = qc[..., scan]
    ds = dqc[..., scan].astype(jnp.float32)
    n = qs.shape[-1]
    idx = jnp.arange(n)
    nz = qs != 0
    marked = jnp.where(nz, idx, -1)
    prev_incl = jax.lax.cummax(marked, axis=marked.ndim - 1)
    pad = jnp.full(qs.shape[:-1] + (1,), -1, marked.dtype)
    prev_excl = jnp.concatenate([pad, prev_incl[..., :-1]], axis=-1)
    gap = (idx - prev_excl - 1).astype(jnp.float32)
    lvl_bits = 1.7 + 2.0 * jnp.log2(jnp.abs(qs).astype(jnp.float32)
                                    + 1.0)
    save = jnp.where(nz, rbits + lvl_bits + 0.55 * gap, 0.0)
    cost = jnp.where(nz, K * ds * ds, 0.0)
    net = cost - lam * save
    suffix = jnp.flip(jnp.cumsum(jnp.flip(net, -1), -1), -1)
    best = jnp.min(suffix, axis=-1, keepdims=True)
    at = jnp.argmin(suffix, axis=-1)[..., None]
    cut = jnp.where(best < 0, at, n)
    mask = idx < cut
    mask = mask[..., inv_scan]
    return qc * mask, dqc * mask


def _eval_merge_level(src_y_big, src_u_big, src_v_big, y0m, x0m,
                      cand_r, cand_c, cand_ref, bsz,
                      refs_y, refs_u, refs_v, n_refs, W, H,
                      pq_y, pq_u, pq_v, lam,
                      tx_y, tx_uv, scan_ym, scan_cm, filt=None):
    """RD-code one merged partition level (bsz in {32, 64}) for all Bm
    blocks: pick the best MV among the child candidates, motion
    compensate at bsz, transform-code luma at tx_y and chroma at tx_uv,
    and apply the RD skip trial.  Redesigned from the reference's
    recursive rd_pick_sb_modes at larger bsizes
    (av1/encoder/partition_search.c:930) as a batched tensor pass.

    Returns (mv_r, mv_c, ref, qy_s, qu_s, qv_s (scan order), eobs,
    rec_y, rec_u, rec_v, d_total, r_total)."""
    Bm = src_y_big.shape[0]
    csz = bsz >> 1
    syf = src_y_big.astype(jnp.float32)

    def mc_y(mvr, mvc, rf):
        cr, cc_ = _clamp_mv(mvr, mvc, bsz, bsz, 0, 0, x0m, y0m, W, H,
                            bsz, bsz)
        if n_refs == 1:
            return _mc_block(refs_y[0], x0m, y0m, bsz, bsz, cr, cc_,
                             filt=filt)
        pa = _mc_block(refs_y[0], x0m, y0m, bsz, bsz, cr, cc_, filt=filt)
        pb = _mc_block(refs_y[1], x0m, y0m, bsz, bsz, cr, cc_, filt=filt)
        return jnp.where(rf[:, None, None] == 0, pa, pb)

    best = None
    for k in range(cand_r.shape[1]):
        pk = mc_y(cand_r[:, k], cand_c[:, k], cand_ref[:, k])
        d = pk.astype(jnp.float32) - syf
        ck = (d * d).sum((1, 2)) + (MV_COST_W / 8.0) * (
            jnp.abs(cand_r[:, k])
            + jnp.abs(cand_c[:, k])).astype(jnp.float32)
        if best is None:
            best = (ck, cand_r[:, k], cand_c[:, k], cand_ref[:, k], pk)
        else:
            bc, br, bcc, brf, bp = best
            lt = ck < bc
            best = (jnp.where(lt, ck, bc),
                    jnp.where(lt, cand_r[:, k], br),
                    jnp.where(lt, cand_c[:, k], bcc),
                    jnp.where(lt, cand_ref[:, k], brf),
                    jnp.where(lt[:, None, None], pk, bp))
    _, mv_r, mv_c, ref, pred_y = best

    n_y = scan_ym.shape[0]
    n_c = scan_cm.shape[0]
    dc_y = np.arange(n_y) == 0
    dc_c = np.arange(n_c) == 0
    iscan_ym = np.argsort(scan_ym)
    iscan_cm = np.argsort(scan_cm)
    resid_y = src_y_big - pred_y.astype(jnp.int32)
    coeff_y = fwd_txfm2d_batched(resid_y, tx_y, c.DCT_DCT)
    qy, dqy = _quantize_jnp(coeff_y, pq_y, CF._tx_scale(tx_y), dc_y)
    qy, dqy = _rd_dropout(qy, dqy, scan_ym, iscan_ym, lam, tx_y)
    bits_y, eob_y = _est_bits(qy, scan_ym)
    rec_y = inv_txfm2d_add_batched(dqy, pred_y, tx_y, c.DCT_DCT)
    rec_y = jnp.where((eob_y > 0)[:, None, None], rec_y, pred_y)

    xc = x0m >> 1
    yc = y0m >> 1
    crc, cccol = _clamp_mv(mv_r, mv_c, csz, csz, 1, 1, x0m, y0m, W, H,
                           bsz, bsz)
    out_c = []
    for (src_p, refs_p, pq_p) in ((src_u_big, refs_u, pq_u),
                                  (src_v_big, refs_v, pq_v)):
        if n_refs == 1:
            pred = _mc_block(refs_p[0], xc, yc, csz, csz, crc, cccol,
                             filt=filt)
        else:
            p0 = _mc_block(refs_p[0], xc, yc, csz, csz, crc, cccol,
                           filt=filt)
            p1 = _mc_block(refs_p[1], xc, yc, csz, csz, crc, cccol,
                           filt=filt)
            pred = jnp.where(ref[:, None, None] == 0, p0, p1)
        resid = src_p - pred.astype(jnp.int32)
        coeff = fwd_txfm2d_batched(resid, tx_uv, c.DCT_DCT)
        qc, dqc = _quantize_jnp(coeff, pq_p, CF._tx_scale(tx_uv), dc_c)
        qc, dqc = _rd_dropout(qc, dqc, scan_cm, iscan_cm, lam, tx_uv)
        bits_c, eob = _est_bits(qc, scan_cm)
        rec = inv_txfm2d_add_batched(dqc, pred, tx_uv, c.DCT_DCT)
        rec = jnp.where((eob > 0)[:, None, None], rec, pred)
        out_c.append((qc, eob, rec, bits_c, src_p, pred))

    def ssd3(a, b):
        d = a.astype(jnp.float32) - b.astype(jnp.float32)
        return (d * d).sum((1, 2))

    d_code = ssd3(rec_y, src_y_big) + ssd3(out_c[0][2], out_c[0][4]) \
        + ssd3(out_c[1][2], out_c[1][4])
    d_skip = ssd3(pred_y, src_y_big) + ssd3(out_c[0][5], out_c[0][4]) \
        + ssd3(out_c[1][5], out_c[1][4])
    r_code = bits_y + out_c[0][3] + out_c[1][3] + 2.0
    skip_rd = d_skip + lam * 1.0 <= d_code + lam * r_code
    sk3 = skip_rd[:, None, None]
    qy = jnp.where(skip_rd[:, None], 0, qy)
    eob_y = jnp.where(skip_rd, 0, eob_y)
    rec_y = jnp.where(sk3, pred_y, rec_y)
    out_c = [(jnp.where(skip_rd[:, None], 0, qc),
              jnp.where(skip_rd, 0, eob),
              jnp.where(sk3, pred, rec))
             for (qc, eob, rec, _, _, pred) in out_c]
    (qu, eob_u, rec_u), (qv, eob_v, rec_v) = out_c
    d_tot = jnp.where(skip_rd, d_skip, d_code)
    r_tot = jnp.where(skip_rd, 1.0, r_code)
    qy_s = qy.astype(jnp.int16)[:, scan_ym]
    qu_s = qu.astype(jnp.int16)[:, scan_cm]
    qv_s = qv.astype(jnp.int16)[:, scan_cm]
    return (mv_r, mv_c, ref, qy_s, qu_s, qv_s,
            (eob_y, eob_u, eob_v), rec_y, rec_u, rec_v, d_tot, r_tot)


def rd_lambda(qindex: int) -> np.float32:
    """Frame RD lambda (SSE per bit), matching the host RD paths
    (encoder/lossy.py: 0.12 * qstep^2 with qstep in pixel units)."""
    qstep = Q.ac_quant_qtx(qindex, 0, 8) / 8.0
    return np.float32(0.12 * qstep * qstep)


def _p_frame_core(key):
    """Unjitted whole-frame P encode closure (shared by the single-
    device jit and the FPMT 'frame'-axis sharded batch).

    key = (H, W, n_refs, merge, interp): with merge=True the fixed-16x16
    coding pass is followed by a bottom-up partition DP over {16, 32, 64}
    squares (av1_rd_pick_partition analog, partition_search.c:5310):
    each 32 (and 64) block is RD-coded as one unit from its children's
    MV candidates, and merged wherever distortion + coefficient bits +
    mode overhead beat the sum of its children."""
    H, W, n_refs, merge = key[:4]
    interp = key[4] if len(key) > 4 else False
    nby, nbx = H // 16, W // 16
    B = nby * nbx
    by, bx = np.meshgrid(np.arange(nby), np.arange(nbx), indexing="ij")
    # numpy closure constants (inlined at trace time — see FILT8 note)
    y0 = (by.ravel() * 16).astype(np.int32)
    x0 = (bx.ravel() * 16).astype(np.int32)
    scan_y = np.asarray(tables.scan(c.TX_16X16, c.DCT_DCT))
    scan_c = np.asarray(tables.scan(c.TX_8X8, c.DCT_DCT))
    scan_32 = np.asarray(tables.scan(c.TX_32X32, c.DCT_DCT))
    scan_64 = np.asarray(tables.scan(c.TX_64X64, c.DCT_DCT))
    iscan_y = np.argsort(scan_y)
    iscan_c = np.argsort(scan_c)
    dc_y = np.arange(256) == 0
    dc_c = np.arange(64) == 0
    nby2, nbx2 = nby // 2, nbx // 2
    nby4, nbx4 = nby2 // 2, nbx2 // 2
    do32 = merge and nby2 > 0 and nbx2 > 0
    do64 = merge and nby4 > 0 and nbx4 > 0

    def fn(src_y, src_u, src_v, refs_y, refs_u, refs_v, refs_y2,
           pq_arr_y, pq_arr_u, pq_arr_v, lam, hp=0):
        """refs_*: (R, Hp, Wp) stacked padded ref planes; refs_y2 the
        half-res luma (sum-pooled); lam: RD lambda (SSE per bit) for
        the skip decision; hp: per-frame allow_high_precision_mv flag
        (traced scalar; gates the eighth-pel refine)."""
        pq_y = _PQ(pq_arr_y)
        pq_u = _PQ(pq_arr_u)
        pq_v = _PQ(pq_arr_v)
        sy_blk = src_y.reshape(nby, 16, nbx, 16).transpose(0, 2, 1, 3) \
            .reshape(B, 16, 16).astype(jnp.int32)

        # --- per-ref search ---
        per_ref = []
        for ri in range(n_refs):
            fdy, fdx, fcost = _fullpel_search(sy_blk, refs_y[ri],
                                              refs_y2[ri], y0, x0, 16,
                                              grid=(nby, nbx))
            mv_r, mv_c, pred, _ = _subpel_refine(
                sy_blk, refs_y[ri], y0, x0, 16, fdy, fdx, W, H, hp=hp)
            d = pred.astype(jnp.float32) - sy_blk.astype(jnp.float32)
            cost = (d * d).sum((1, 2))
            per_ref.append((cost, mv_r, mv_c, pred))
        if n_refs == 1:
            best_ref = jnp.zeros(B, jnp.int32)
            cost, mv_r, mv_c, pred_y = per_ref[0]
        else:
            costs = jnp.stack([t[0] for t in per_ref], 1)
            best_ref = jnp.argmin(costs, axis=1).astype(jnp.int32)
            sel = best_ref[:, None, None]
            mv_r = jnp.stack([t[1] for t in per_ref], 1)[
                jnp.arange(B), best_ref]
            mv_c = jnp.stack([t[2] for t in per_ref], 1)[
                jnp.arange(B), best_ref]
            pred_y = jnp.where(
                sel == 0, per_ref[0][3], per_ref[1][3])

        # --- (MV, ref) consensus snap (one parallel relaxation) ---
        # The emitter codes NEARESTMV/NEARMV when a block's MV exactly
        # equals a ref-MV-stack candidate, and the stack's candidates
        # ARE the left/top neighbors' MVs (spec 7.10.2; mvref.py).
        # Candidates carry BOTH an MV and a reference, so a block on a
        # dithered long-range ARF vector can move to the coherent LAST
        # field (or to zero -> GLOBALMV) when the SSD increase is under
        # the NEWMV rate premium at the frame lambda.  Lossy references
        # make raw per-block argmin MVs scatter (~100 unique vectors on
        # a clean pan); this consolidation is what lets the syntax
        # adapt to nothing.
        mvr_g = mv_r.reshape(nby, nbx)
        mvc_g = mv_c.reshape(nby, nbx)
        ref_g = best_ref.reshape(nby, nbx)
        syf32 = sy_blk.astype(jnp.float32)

        def mc_on(cand_r, cand_c, cand_ref):
            crc, ccc = _clamp_mv(cand_r, cand_c, 16, 16, 0, 0, x0, y0,
                                 W, H, 16, 16)
            if n_refs == 1:
                return _mc_block(refs_y[0], x0, y0, 16, 16, crc, ccc)
            pa = _mc_block(refs_y[0], x0, y0, 16, 16, crc, ccc)
            pb = _mc_block(refs_y[1], x0, y0, 16, 16, crc, ccc)
            return jnp.where(cand_ref[:, None, None] == 0, pa, pb)

        def cand_cost(pc):
            dd = pc.astype(jnp.float32) - syf32
            return (dd * dd).sum((1, 2))

        snap = []
        # left/top neighbor candidates (cross-ref: the ref is adopted
        # with the MV)
        for (sr, sc, rg) in (
                (jnp.concatenate([mvr_g[:, :1], mvr_g[:, :-1]], 1),
                 jnp.concatenate([mvc_g[:, :1], mvc_g[:, :-1]], 1),
                 jnp.concatenate([ref_g[:, :1], ref_g[:, :-1]], 1)),
                (jnp.concatenate([mvr_g[:1], mvr_g[:-1]], 0),
                 jnp.concatenate([mvc_g[:1], mvc_g[:-1]], 0),
                 jnp.concatenate([ref_g[:1], ref_g[:-1]], 0))):
            cand_r = sr.reshape(B)
            cand_c = sc.reshape(B)
            cand_ref = rg.reshape(B)
            pc = mc_on(cand_r, cand_c, cand_ref)
            snap.append((cand_cost(pc), cand_r, cand_c, cand_ref, pc))

        def masked_median(vals, mask):
            big = jnp.where(mask, vals, jnp.iinfo(jnp.int32).max)
            srt = jnp.sort(big)
            cnt = mask.sum()
            v = srt[jnp.clip(cnt // 2, 0, B - 1)]
            return jnp.where(cnt > 0, v, 0).astype(vals.dtype)

        # per-reference dominant-MV candidates: the componentwise
        # median of each ref's population (a pan collapses to ONE
        # vector per ref in a single relaxation)
        for ri in range(n_refs):
            msk = best_ref == ri
            mr = masked_median(mv_r, msk)
            mc_ = masked_median(mv_c, msk)
            rr = jnp.full((B,), ri, best_ref.dtype)
            pm = mc_on(jnp.broadcast_to(mr, (B,)),
                       jnp.broadcast_to(mc_, (B,)), rr)
            snap.append((cand_cost(pm), jnp.broadcast_to(mr, (B,)),
                         jnp.broadcast_to(mc_, (B,)), rr, pm))
        # zero-MV-on-LAST candidate (GLOBALMV on the nearest ref): the
        # co-located block, a static strided slice
        pz = _stride_windows(refs_y[0], PADR, PADR, nby, nbx, 16, 16) \
            .astype(jnp.uint8)
        snap.append((cand_cost(pz), jnp.zeros(B, mv_r.dtype),
                     jnp.zeros(B, mv_c.dtype),
                     jnp.zeros(B, best_ref.dtype), pz))
        s_cost = jnp.stack([t[0] for t in snap], 1)
        bi = jnp.argmin(s_cost, 1)
        arB = jnp.arange(B)
        best_c = s_cost[arB, bi]
        # ~rate premium of NEWMV over NEAREST/GLOBAL at working q
        adopt = best_c <= cost + lam * 14.0
        snap_r = jnp.stack([t[1] for t in snap], 1)[arB, bi]
        snap_c = jnp.stack([t[2] for t in snap], 1)[arB, bi]
        snap_f = jnp.stack([t[3] for t in snap], 1)[arB, bi]
        snap_p = snap[0][4]
        for k in range(1, len(snap)):
            snap_p = jnp.where((bi == k)[:, None, None], snap[k][4],
                               snap_p)
        mv_r = jnp.where(adopt, snap_r, mv_r)
        mv_c = jnp.where(adopt, snap_c, mv_c)
        best_ref = jnp.where(adopt, snap_f, best_ref)
        pred_y = jnp.where(adopt[:, None, None], snap_p, pred_y)

        # --- frame-level switchable-filter decision (av1_pick_interp_
        # filter / interp_search.c at frame granularity: one filter per
        # frame, is_filter_switchable=0).  The final MVs re-predict
        # under each bank; the frame picks the min-SSD filter and ALL
        # prediction below (incl. chroma + merge levels) uses it. ---
        fbank = None
        fsel = jnp.int32(0)
        if interp:
            crF, ccF = _clamp_mv(mv_r, mv_c, 16, 16, 0, 0, x0, y0,
                                 W, H, 16, 16)

            def pred_bank(fb):
                if n_refs == 1:
                    return _mc_block(refs_y[0], x0, y0, 16, 16, crF,
                                     ccF, filt=fb)
                pa = _mc_block(refs_y[0], x0, y0, 16, 16, crF, ccF,
                               filt=fb)
                pb = _mc_block(refs_y[1], x0, y0, 16, 16, crF, ccF,
                               filt=fb)
                return jnp.where(best_ref[:, None, None] == 0, pa, pb)

            preds_f = [pred_bank(jnp.asarray(FILT_BANKS[i]))
                       for i in range(3)]
            ssd_f = jnp.stack(
                [((pf.astype(jnp.float32) - syf32) ** 2).sum()
                 for pf in preds_f])
            fsel = jnp.argmin(ssd_f).astype(jnp.int32)
            fbank = jnp.asarray(FILT_BANKS)[fsel]
            pred_y = preds_f[0]
            for i in (1, 2):
                pred_y = jnp.where(fsel == i, preds_f[i], pred_y)

        # --- final residual coding ---
        resid_y = sy_blk - pred_y.astype(jnp.int32)
        coeff_y = fwd_txfm2d_batched(resid_y, c.TX_16X16, c.DCT_DCT)
        qy, dqy = _quantize_jnp(coeff_y, pq_y, CF._tx_scale(c.TX_16X16),
                                dc_y)
        qy, dqy = _rd_dropout(qy, dqy, scan_y, iscan_y, lam, c.TX_16X16)
        bits_y, eob_y = _est_bits(qy, scan_y)
        rec_y = inv_txfm2d_add_batched(dqy, pred_y, c.TX_16X16, c.DCT_DCT)
        rec_y = jnp.where((eob_y > 0)[:, None, None], rec_y, pred_y)

        # chroma (8x8 blocks at half coords; chroma q4 = mv 1/8 luma pel)
        xc = x0 >> 1
        yc = y0 >> 1
        out_c = []
        for (src_p, refs_p, pq_p) in ((src_u, refs_u, pq_u),
                                      (src_v, refs_v, pq_v)):
            sc_blk = src_p.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3) \
                .reshape(B, 8, 8).astype(jnp.int32)
            crc, cccol = _clamp_mv(mv_r, mv_c, 8, 8, 1, 1, x0, y0, W, H,
                                   16, 16)
            if n_refs == 1:
                pred = _mc_block(refs_p[0], xc, yc, 8, 8, crc, cccol,
                                 filt=fbank)
            else:
                p0 = _mc_block(refs_p[0], xc, yc, 8, 8, crc, cccol,
                               filt=fbank)
                p1 = _mc_block(refs_p[1], xc, yc, 8, 8, crc, cccol,
                               filt=fbank)
                pred = jnp.where(best_ref[:, None, None] == 0, p0, p1)
            resid = sc_blk - pred.astype(jnp.int32)
            coeff = fwd_txfm2d_batched(resid, c.TX_8X8, c.DCT_DCT)
            qc, dqc = _quantize_jnp(coeff, pq_p, CF._tx_scale(c.TX_8X8),
                                    dc_c)
            qc, dqc = _rd_dropout(qc, dqc, scan_c, iscan_c, lam,
                                  c.TX_8X8)
            bits_c, eob = _est_bits(qc, scan_c)
            rec = inv_txfm2d_add_batched(dqc, pred, c.TX_8X8, c.DCT_DCT)
            rec = jnp.where((eob > 0)[:, None, None], rec, pred)
            out_c.append((qc, eob, rec, bits_c, sc_blk, pred))

        # --- RD skip decision (rdopt.c skip_txfm trial: code the
        # residual only when the distortion it removes is worth its
        # estimated coefficient bits at this frame's lambda) ---
        def _ssd3(a, b):
            d = a.astype(jnp.float32) - b.astype(jnp.float32)
            return (d * d).sum((1, 2))

        d_code = _ssd3(rec_y, sy_blk) \
            + _ssd3(out_c[0][2], out_c[0][4]) \
            + _ssd3(out_c[1][2], out_c[1][4])
        d_skip = _ssd3(pred_y, sy_blk) \
            + _ssd3(out_c[0][5], out_c[0][4]) \
            + _ssd3(out_c[1][5], out_c[1][4])
        r_code = bits_y + out_c[0][3] + out_c[1][3] + 2.0
        skip_rd = d_skip + lam * 1.0 <= d_code + lam * r_code
        sk3 = skip_rd[:, None, None]
        sk_q = skip_rd.reshape(skip_rd.shape + (1,) * (qy.ndim - 1))
        qy = jnp.where(sk_q, 0, qy)
        eob_y = jnp.where(skip_rd, 0, eob_y)
        rec_y = jnp.where(sk3, pred_y, rec_y)
        out_c = [(jnp.where(
                      skip_rd.reshape(skip_rd.shape
                                      + (1,) * (qc.ndim - 1)), 0, qc),
                  jnp.where(skip_rd, 0, eob),
                  jnp.where(sk3, pred, rec))
                 for (qc, eob, rec, _, _, pred) in out_c]

        def untile(blocks, n):
            return blocks.reshape(nby, nbx, n, n).transpose(0, 2, 1, 3) \
                .reshape(nby * n, nbx * n)

        def untile_pad(blocks, n, n1, n2, Hf, Wf):
            """(n1*n2, n, n) sub-grid blocks -> (Hf, Wf) plane, zero
            beyond the covered region."""
            pl = blocks.reshape(n1, n2, n, n).transpose(0, 2, 1, 3) \
                .reshape(n1 * n, n2 * n)
            return jnp.pad(pl, ((0, Hf - n1 * n), (0, Wf - n2 * n)))

        (qu, eob_u, rec_u), (qv, eob_v, rec_v) = out_c
        d16f = jnp.where(skip_rd, d_skip, d_code)
        r16f = jnp.where(skip_rd, 1.0, r_code)

        # --- bottom-up partition merge DP over {16, 32, 64} squares ---
        def qgrid(a, n1, n2):
            """(>=2*n1, >=2*n2) grid -> (n1*n2, 4) 2x2 child groups."""
            return a[:2 * n1, :2 * n2].reshape(n1, 2, n2, 2) \
                .transpose(0, 2, 1, 3).reshape(n1 * n2, 4)

        def merge_hdr(mvr, mvc, rf, eobs, part, qys, qus, qvs, cy, cc_):
            eo_y, eo_u, eo_v = eobs
            ctr16b = jnp.concatenate([qys[:, :cy], qus[:, :cc_],
                                      qvs[:, :cc_]], axis=1)
            need = ((eo_y > cy) | (eo_u > cc_) | (eo_v > cc_)
                    | (jnp.abs(ctr16b).max(axis=1) > 127))
            h = jnp.stack([mvr, mvc, rf, eo_y, eo_u, eo_v,
                           need.astype(jnp.int32),
                           part.astype(jnp.int32)], axis=1) \
                .astype(jnp.int16)
            return (h, jnp.clip(ctr16b, -127, 127).astype(jnp.int8),
                    jnp.concatenate([qys, qus, qvs], axis=1))

        lvl16 = jnp.zeros((nby, nbx), jnp.int8)
        if do32:
            B32 = nby2 * nbx2
            mr4 = qgrid(mv_r.reshape(nby, nbx), nby2, nbx2)
            mc4 = qgrid(mv_c.reshape(nby, nbx), nby2, nbx2)
            rf4 = qgrid(best_ref.reshape(nby, nbx), nby2, nbx2)
            med_r = _lower_median4(mr4)
            med_c = _lower_median4(mc4)
            maj = (rf4.sum(1) >= 2).astype(rf4.dtype) if n_refs == 2 \
                else jnp.zeros(B32, rf4.dtype)
            cand_r32 = jnp.concatenate([mr4, med_r[:, None]], 1)
            cand_c32 = jnp.concatenate([mc4, med_c[:, None]], 1)
            cand_f32 = jnp.concatenate([rf4, maj[:, None]], 1)
            r2g, c2g = np.meshgrid(np.arange(nby2), np.arange(nbx2),
                                   indexing="ij")
            y0m32 = (r2g.ravel() * 32).astype(np.int32)
            x0m32 = (c2g.ravel() * 32).astype(np.int32)

            def tile_sub(p, n, n1, n2):
                return p[:n1 * n, :n2 * n].reshape(n1, n, n2, n) \
                    .transpose(0, 2, 1, 3).reshape(n1 * n2, n, n) \
                    .astype(jnp.int32)

            (mv32r, mv32c, ref32, qy32, qu32, qv32, eobs32, ry32, ru32,
             rv32, d32, r32) = _eval_merge_level(
                tile_sub(src_y, 32, nby2, nbx2),
                tile_sub(src_u, 16, nby2, nbx2),
                tile_sub(src_v, 16, nby2, nbx2),
                y0m32, x0m32, cand_r32, cand_c32, cand_f32, 32,
                refs_y, refs_u, refs_v, n_refs, W, H,
                pq_y, pq_u, pq_v, lam,
                c.TX_32X32, c.TX_16X16, scan_32, scan_y, filt=fbank)
            cost16g = (d16f + lam * (r16f + OH16)).reshape(nby, nbx)
            split32 = qgrid(cost16g, nby2, nbx2).sum(1) + lam * R_SPLIT
            cost32n = d32 + lam * (r32 + OH32)
            part32 = cost32n < split32
            best32 = jnp.minimum(cost32n, split32)
            h32, ctr32, cfull32 = merge_hdr(
                mv32r, mv32c, ref32, eobs32, part32, qy32, qu32, qv32,
                CAPY32, CAPC32)
            lvl16 = jnp.where(
                jnp.pad(jnp.repeat(jnp.repeat(
                    part32.reshape(nby2, nbx2), 2, 0), 2, 1),
                    ((0, nby - 2 * nby2), (0, nbx - 2 * nbx2))),
                jnp.int8(1), lvl16)
        else:
            h32 = jnp.zeros((0, 8), jnp.int16)
            ctr32 = jnp.zeros((0, CAPY32 + 2 * CAPC32), jnp.int8)
            cfull32 = jnp.zeros((0, 1536), jnp.int16)
        if do64:
            B64 = nby4 * nbx4
            mr4 = qgrid(mv32r.reshape(nby2, nbx2), nby4, nbx4)
            mc4 = qgrid(mv32c.reshape(nby2, nbx2), nby4, nbx4)
            rf4 = qgrid(ref32.reshape(nby2, nbx2), nby4, nbx4)
            med_r = _lower_median4(mr4)
            med_c = _lower_median4(mc4)
            maj = (rf4.sum(1) >= 2).astype(rf4.dtype) if n_refs == 2 \
                else jnp.zeros(B64, rf4.dtype)
            cand_r64 = jnp.concatenate([mr4, med_r[:, None]], 1)
            cand_c64 = jnp.concatenate([mc4, med_c[:, None]], 1)
            cand_f64 = jnp.concatenate([rf4, maj[:, None]], 1)
            r4g, c4g = np.meshgrid(np.arange(nby4), np.arange(nbx4),
                                   indexing="ij")
            y0m64 = (r4g.ravel() * 64).astype(np.int32)
            x0m64 = (c4g.ravel() * 64).astype(np.int32)
            (mv64r, mv64c, ref64, qy64, qu64, qv64, eobs64, ry64, ru64,
             rv64, d64, r64) = _eval_merge_level(
                tile_sub(src_y, 64, nby4, nbx4),
                tile_sub(src_u, 32, nby4, nbx4),
                tile_sub(src_v, 32, nby4, nbx4),
                y0m64, x0m64, cand_r64, cand_c64, cand_f64, 64,
                refs_y, refs_u, refs_v, n_refs, W, H,
                pq_y, pq_u, pq_v, lam,
                c.TX_64X64, c.TX_32X32, scan_64, scan_32, filt=fbank)
            split64 = qgrid(best32.reshape(nby2, nbx2),
                            nby4, nbx4).sum(1) + lam * R_SPLIT
            cost64n = d64 + lam * (r64 + OH64)
            part64 = cost64n < split64
            h64, ctr64, cfull64 = merge_hdr(
                mv64r, mv64c, ref64, eobs64, part64, qy64, qu64, qv64,
                CAPY64, CAPC64)
            lvl16 = jnp.where(
                jnp.pad(jnp.repeat(jnp.repeat(
                    part64.reshape(nby4, nbx4), 4, 0), 4, 1),
                    ((0, nby - 4 * nby4), (0, nbx - 4 * nbx4))),
                jnp.int8(2), lvl16)
        else:
            h64 = jnp.zeros((0, 8), jnp.int16)
            ctr64 = jnp.zeros((0, CAPY64 + 2 * CAPC64), jnp.int8)
            cfull64 = jnp.zeros((0, 3072), jnp.int16)

        # D2H shipping plan (few, small arrays per frame): a small
        # header, SCAN-ORDER coefficients truncated at CAPY/CAPC and
        # saturated to int8 (covers >p99 of blocks at
        # working q), a per-block overflow flag (hdr col 6), the full
        # int16 scan-order buffer left device-resident for the rare
        # flagged blocks (host batch-fetches them), and the packed
        # recon.
        qy_s = qy.astype(jnp.int16).reshape(B, 256)[:, scan_y]
        qu_s = qu.astype(jnp.int16).reshape(B, 64)[:, scan_c]
        qv_s = qv.astype(jnp.int16).reshape(B, 64)[:, scan_c]
        cfull = jnp.concatenate([qy_s, qu_s, qv_s], axis=1)
        ctr16 = jnp.concatenate([qy_s[:, :CAPY], qu_s[:, :CAPC],
                                 qv_s[:, :CAPC]], axis=1)
        need_full = ((eob_y > CAPY) | (eob_u > CAPC) | (eob_v > CAPC)
                     | (jnp.abs(ctr16).max(axis=1) > 127))
        hdr = jnp.concatenate([
            mv_r.astype(jnp.int16)[:, None],
            mv_c.astype(jnp.int16)[:, None],
            best_ref.astype(jnp.int16)[:, None],
            eob_y.astype(jnp.int16)[:, None],
            eob_u.astype(jnp.int16)[:, None],
            eob_v.astype(jnp.int16)[:, None],
            need_full.astype(jnp.int16)[:, None]], axis=1)
        ctr = jnp.clip(ctr16, -127, 127).astype(jnp.int8)

        # final reconstruction: each pixel from its chosen leaf's recon
        rec_y_full = untile(rec_y, 16)
        rec_u_full = untile(rec_u, 8)
        rec_v_full = untile(rec_v, 8)
        if do32:
            m = jnp.repeat(jnp.repeat(lvl16 == 1, 16, 0), 16, 1)
            rec_y_full = jnp.where(
                m, untile_pad(ry32, 32, nby2, nbx2, H, W), rec_y_full)
            mc2 = jnp.repeat(jnp.repeat(lvl16 == 1, 8, 0), 8, 1)
            rec_u_full = jnp.where(
                mc2, untile_pad(ru32, 16, nby2, nbx2, H // 2, W // 2),
                rec_u_full)
            rec_v_full = jnp.where(
                mc2, untile_pad(rv32, 16, nby2, nbx2, H // 2, W // 2),
                rec_v_full)
        if do64:
            m = jnp.repeat(jnp.repeat(lvl16 == 2, 16, 0), 16, 1)
            rec_y_full = jnp.where(
                m, untile_pad(ry64, 64, nby4, nbx4, H, W), rec_y_full)
            mc2 = jnp.repeat(jnp.repeat(lvl16 == 2, 8, 0), 8, 1)
            rec_u_full = jnp.where(
                mc2, untile_pad(ru64, 32, nby4, nbx4, H // 2, W // 2),
                rec_u_full)
            rec_v_full = jnp.where(
                mc2, untile_pad(rv64, 32, nby4, nbx4, H // 2, W // 2),
                rec_v_full)
        rec = jnp.concatenate([
            rec_y_full.astype(jnp.uint8),
            jnp.concatenate([rec_u_full.astype(jnp.uint8),
                             rec_v_full.astype(jnp.uint8)],
                            axis=1)], axis=0)
        if not merge:
            return hdr, ctr, cfull, rec
        return (hdr, ctr, cfull, rec, lvl16,
                h32, ctr32, cfull32, h64, ctr64, cfull64, fsel)

    return fn


def _p_frame_fn(key):
    if key in _FN_CACHE:
        return _FN_CACHE[key]
    fn = jax.jit(_p_frame_core(key))
    _FN_CACHE[key] = fn
    return fn


def overflow_idx(hdr):
    """Indices of blocks whose full int16 rows must be fetched: hdr
    col 6 (device-computed flag) when present, else the eob caps."""
    if hdr.shape[1] > 6:
        return np.nonzero(hdr[:, 6])[0]
    return np.nonzero((hdr[:, 3] > CAPY) | (hdr[:, 4] > CAPC)
                      | (hdr[:, 5] > CAPC))[0]


def assemble_res(hdr, coeff_scan, fetch_rows=None):
    """hdr (B, 6|7) int16 + SCAN-order coefficients (truncated int8 or
    full int16) -> the raster-layout (B, 390) buffer the emitters
    consume.  fetch_rows: callable(idx) -> (k, 384) full scan rows for
    the flagged blocks (a tiny targeted fetch)."""
    B = hdr.shape[0]
    scan16 = np.asarray(tables.scan(c.TX_16X16, c.DCT_DCT))
    scan8 = np.asarray(tables.scan(c.TX_8X8, c.DCT_DCT))
    res = np.zeros((B, 390), np.int16)
    res[:, :6] = hdr[:, :6]
    if coeff_scan.shape[1] == 384:
        res[:, 6 + scan16] = coeff_scan[:, :256]
        res[:, 262 + scan8] = coeff_scan[:, 256:320]
        res[:, 326 + scan8] = coeff_scan[:, 320:]
        return res
    cs = coeff_scan.astype(np.int16)
    res[:, 6 + scan16[:CAPY]] = cs[:, :CAPY]
    res[:, 262 + scan8[:CAPC]] = cs[:, CAPY:CAPY + CAPC]
    res[:, 326 + scan8[:CAPC]] = cs[:, CAPY + CAPC:]
    idx = overflow_idx(hdr)
    if idx.size:
        rows = np.asarray(fetch_rows(idx), np.int16)
        res[idx[:, None], 6 + scan16[None, :]] = rows[:, :256]
        res[idx[:, None], 262 + scan8[None, :]] = rows[:, 256:320]
        res[idx[:, None], 326 + scan8[None, :]] = rows[:, 320:]
    return res


def assemble_group_res(hdr, ctr, cfull_d):
    """Whole-group raw assembly: hdr (L, B, 7) + ctr (L, B, cols)
    fetched numpy, cfull_d the (L, B, 384) device-resident full buffer.
    All flagged blocks across ALL frames fetch in ONE gather (one
    transfer per group instead of one per frame)."""
    L, B = hdr.shape[:2]
    flat = np.concatenate([overflow_idx(hdr[j]) + j * B
                           for j in range(L)])
    rows_by_frame = [None] * L
    if flat.size:
        rows = np.asarray(cfull_d.reshape(L * B, 384)[jnp.asarray(flat)],
                          np.int16)
        pos = 0
        for j in range(L):
            k = overflow_idx(hdr[j]).size
            rows_by_frame[j] = rows[pos:pos + k]
            pos += k
    return [assemble_res(hdr[j], ctr[j],
                         lambda idx, j=j: rows_by_frame[j])
            for j in range(L)]


def _assemble_level(hdr, coeff_scan, ny, nc, cy, cc_, scan_ym, scan_cm,
                    fetch_rows=None):
    """Generic merged-level raster assembly: hdr (Bm, 8) int16 +
    truncated int8 scan coefficients -> (Bm, 6 + ny + 2*nc) int16 with
    raster-layout coefficients (the emitters' qcoeff layout).  Blocks
    flagged in hdr col 6 get their full int16 rows via fetch_rows."""
    B = hdr.shape[0]
    res = np.zeros((B, 6 + ny + 2 * nc), np.int16)
    if B == 0:
        return res
    res[:, :6] = hdr[:, :6]
    cs = coeff_scan.astype(np.int16)
    res[:, 6 + scan_ym[:cy]] = cs[:, :cy]
    res[:, 6 + ny + scan_cm[:cc_]] = cs[:, cy:cy + cc_]
    res[:, 6 + ny + nc + scan_cm[:cc_]] = cs[:, cy + cc_:cy + 2 * cc_]
    idx = np.nonzero(hdr[:, 6])[0]
    if idx.size:
        rows = np.asarray(fetch_rows(idx), np.int16)
        res[idx[:, None], 6 + scan_ym[None, :]] = rows[:, :ny]
        res[idx[:, None], 6 + ny + scan_cm[None, :]] = rows[:, ny:ny + nc]
        res[idx[:, None], 6 + ny + nc + scan_cm[None, :]] = \
            rows[:, ny + nc:]
    return res


def _level_params(bsz: int):
    """(ny, nc, capy, capc, scan_y, scan_c) for a merged level."""
    if bsz == 32:
        return (1024, 256, CAPY32, CAPC32,
                np.asarray(tables.scan(c.TX_32X32, c.DCT_DCT)),
                np.asarray(tables.scan(c.TX_16X16, c.DCT_DCT)))
    return (1024, 1024, CAPY64, CAPC64,
            np.asarray(tables.scan(c.TX_64X64, c.DCT_DCT)),
            np.asarray(tables.scan(c.TX_32X32, c.DCT_DCT)))


def _assemble_group_level(hdr, ctr, cfull_d, bsz):
    """Per-frame merged-level assembly with ONE overflow gather across
    the whole group (hdr (L, Bm, 8))."""
    L, B = hdr.shape[:2]
    ny, nc, cy, cc_, scan_ym, scan_cm = _level_params(bsz)
    if B == 0:
        return [np.zeros((0, 6 + ny + 2 * nc), np.int16)
                for _ in range(L)]
    flat = np.concatenate([np.nonzero(hdr[j][:, 6])[0] + j * B
                           for j in range(L)])
    rows_by_frame = [None] * L
    if flat.size:
        rows = np.asarray(
            cfull_d.reshape(L * B, -1)[jnp.asarray(flat)], np.int16)
        pos = 0
        for j in range(L):
            k = np.count_nonzero(hdr[j][:, 6])
            rows_by_frame[j] = rows[pos:pos + k]
            pos += k
    return [_assemble_level(hdr[j], ctr[j], ny, nc, cy, cc_, scan_ym,
                            scan_cm, lambda idx, j=j: rows_by_frame[j])
            for j in range(L)]


def assemble_group_merge(hdr, ctr, cfull_d, lvl, h32, c32, cfull32_d,
                         h64, c64, cfull64_d):
    """Whole-group assembly of the variable-partition result format.
    Returns a list of per-frame dicts: r16 (B,390), r32 (B32,1542),
    r64 (B64,3078) raster buffers plus the lvl (nby,nbx) uint8 map
    (0=16x16 leaf, 1=merged 32, 2=merged 64)."""
    raws16 = assemble_group_res(hdr, ctr, cfull_d)
    r32s = _assemble_group_level(h32, c32, cfull32_d, 32)
    r64s = _assemble_group_level(h64, c64, cfull64_d, 64)
    return [dict(r16=raws16[j], r32=r32s[j], r64=r64s[j],
                 lvl=np.asarray(lvl[j], np.uint8))
            for j in range(len(raws16))]


def pack_frame_results(res_buf, W):
    """Packed device result buffer (B, 390) int16 -> the per-block dict
    the host emitter (encoder/tpu_inter.py) walks.  Layout per block:
    [mv_r, mv_c, ref, eob_y, eob_u, eob_v, qy*256, qu*64, qv*64]."""
    nbx = W // 16
    res = {}
    for b in range(res_buf.shape[0]):
        r, cc = divmod(b, nbx)
        row = res_buf[b]
        res[(r, cc)] = dict(
            mv=(int(row[0]), int(row[1])), ref_idx=int(row[2]),
            qy=row[6:262], eoby=int(row[3]), qu=row[262:326],
            eobu=int(row[4]), qv=row[326:390], eobv=int(row[5]))
    return res


def split_recon(rec, H, W):
    """Packed uint8 recon buffer (H + H//2, W) -> (y, u, v) planes."""
    rec_y = rec[:H]
    rec_u = rec[H:, :W // 2]
    rec_v = rec[H:, W // 2:]
    return rec_y, rec_u, rec_v


def _pad_ref_jnp(y, u, v):
    """Device-side ref prep: PADR edge padding + half-res luma (the
    two-scale search pyramid).  Runs inside the chain scan so recon
    never round-trips to the host between frames."""
    py = jnp.pad(y, PADR, mode="edge")
    pu = jnp.pad(u, PADR, mode="edge")
    pv = jnp.pad(v, PADR, mode="edge")
    y32 = py.astype(jnp.int32)
    h2 = (y32.shape[0] // 2) * 2
    w2 = (y32.shape[1] // 2) * 2
    y2 = y32[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).sum((1, 3))
    return py, pu, pv, y2


_CHAIN_FN_CACHE = {}


def _p_chain_fn(key):
    """jitted GF-group P-frame chain: ONE device program encodes L
    consecutive P frames (lax.scan), each referencing the previous
    frame's recon (LAST, device-resident carry) and optionally a fixed
    ARF.  Batched replacement for the reference's per-frame encode
    loop (av1/encoder/encode_strategy.c): the whole group ships as one
    dispatch and one packed fetch.

    Each frame's recon is DEBLOCKED on device (ops/deblock_jnp.py,
    per-frame q-derived levels) before it becomes the next LAST carry —
    the in-loop filter stays in the loop, matching the decoder
    (av1/common/av1_loopfilter.c applied per frame before reference
    update)."""
    if key in _CHAIN_FN_CACHE:
        return _CHAIN_FN_CACHE[key]
    H, W, n_refs, sharpness, interp = key
    base = _p_frame_core((H, W, n_refs, True, interp))
    from .deblock_jnp import deblock_leafmask
    nby, nbx = H // 16, W // 16

    def leaf_ids(lvl16):
        """Per-16-block coding-leaf id from the partition level map."""
        bi = jnp.arange(nby * nbx, dtype=jnp.int32).reshape(nby, nbx)
        rr = jnp.arange(nby)[:, None]
        cc_ = jnp.arange(nbx)[None, :]
        id32 = ((rr & ~1) * nbx + (cc_ & ~1)).astype(jnp.int32)
        id64 = ((rr & ~3) * nbx + (cc_ & ~3)).astype(jnp.int32)
        return jnp.where(lvl16 == 2, id64,
                         jnp.where(lvl16 == 1, id32, bi))

    def fn(srcs_y, srcs_u, srcs_v, last_y, last_u, last_v,
           arf_y, arf_u, arf_v, pq_stack, lf_stack, lam_stack,
           hp_stack):
        """srcs_*: (L, ...) uint8; last_*/arf_*: unpadded ref planes;
        pq_stack: (L, 3, pqlen) per-frame quantizer arrays; lf_stack:
        (L, 3) per-frame (y, u, v) loop-filter levels (0 = off);
        lam_stack: (L,) per-frame RD lambdas; hp_stack: (L,) per-frame
        allow_high_precision_mv flags."""
        apy, apu, apv, ay2 = _pad_ref_jnp(arf_y, arf_u, arf_v)

        def body(carry, xs):
            ly, lu, lv, ly2 = carry
            sy, su, sv, pq, lf, lm, hp = xs
            if n_refs == 2:
                ry = jnp.stack([ly, apy])
                ru = jnp.stack([lu, apu])
                rv = jnp.stack([lv, apv])
                ry2 = jnp.stack([ly2, ay2])
            else:
                ry, ru, rv, ry2 = ly[None], lu[None], lv[None], ly2[None]
            (hdr, ctr, cfull, rec, lvl16, h32, ctr32, cfull32, h64,
             ctr64, cfull64, fsel) = base(sy, su, sv, ry, ru, rv, ry2,
                                          pq[0], pq[1], pq[2], lm,
                                          hp=hp)
            rec_y, rec_u, rec_v = deblock_leafmask(
                rec[:H], rec[H:, :W // 2], rec[H:, W // 2:],
                lf[0], lf[1], lf[2], leaf_ids(lvl16),
                sharpness=sharpness)
            rec = jnp.concatenate([
                rec_y, jnp.concatenate([rec_u, rec_v], axis=1)], axis=0)
            return (_pad_ref_jnp(rec_y, rec_u, rec_v),
                    (hdr, ctr, cfull, rec, lvl16, h32, ctr32, cfull32,
                     h64, ctr64, cfull64, fsel))

        init = _pad_ref_jnp(last_y, last_u, last_v)
        _, outs = jax.lax.scan(
            body, init, (srcs_y, srcs_u, srcs_v, pq_stack, lf_stack,
                         lam_stack, hp_stack))
        return outs

    jitted = jax.jit(fn)
    _CHAIN_FN_CACHE[key] = jitted
    return jitted


class DeviceChainEncoder:
    """Whole-GF-group batched P-frame encode: one dispatch + one fetch
    for L frames (chained LAST + fixed ARF), per-frame qindex allowed.

    Quantizers are precomputed per frame before the batch — the same
    property as the reference's FPMT (frame-parallel frames cannot see
    in-flight rate feedback, av1/av1_cx_iface.c:3374)."""

    def encode_chain(self, src_frames, qindexes, last_planes,
                     arf_planes=None, recon: str = "last",
                     lf_levels=None, sharpness: int = 0,
                     interp_search: bool = True):
        """src_frames: list of L (y, u, v); returns (results, recons,
        raws): results[j] = per-block dict, recons[j] = (y, u, v) uint8
        (None for frames not fetched), raws[j] = (B, 390) int16.

        lf_levels: per-frame (y, u, v) deblock levels applied on device
        (None = unfiltered chain); the caller must signal the SAME
        levels in each frame header so the decoder's in-loop filter
        reproduces the carry.

        recon='last' fetches only the final frame's reconstruction —
        within a GF group the intermediate P recons live only on device
        (the next frame's LAST carry) and the host never reads them.

        src_frames / last_planes / arf_planes may be device arrays
        (jax) — the GOP driver uploads each source frame ONCE per group
        and every consumer (TPL, temporal filter, this chain) reuses the
        device-resident copy."""
        L = len(src_frames)
        H, W = src_frames[0][0].shape[:2]
        assert H % 16 == 0 and W % 16 == 0
        n_refs = 2 if arf_planes is not None else 1
        fn = _p_chain_fn((H, W, n_refs, sharpness, bool(interp_search)))
        pq_rows = []
        for q in qindexes:
            pq_rows.append(np.stack(
                [_pq_array(Q.build_plane_quant(q, 0, 0))] * 3))
        pq_stack = np.stack(pq_rows)
        if lf_levels is None:
            lf_stack = np.zeros((L, 3), np.int32)
        else:
            lf_stack = np.asarray(
                [lv if isinstance(lv, (tuple, list)) else (lv,) * 3
                 for lv in lf_levels], np.int32)
        lam_stack = np.asarray([rd_lambda(q) for q in qindexes],
                               np.float32)
        hp_stack = np.asarray([1 if q < 128 else 0 for q in qindexes],
                              np.int32)
        stk = (jnp.stack if not isinstance(src_frames[0][0], np.ndarray)
               else np.stack)
        srcs_y = stk([f[0][:H, :W] for f in src_frames])
        srcs_u = stk([f[1][:H >> 1, :W >> 1] for f in src_frames])
        srcs_v = stk([f[2][:H >> 1, :W >> 1] for f in src_frames])
        lp = last_planes
        ap = arf_planes if arf_planes is not None else last_planes
        out = fn(
            srcs_y, srcs_u, srcs_v,
            lp[0][:H, :W], lp[1][:H >> 1, :W >> 1],
            lp[2][:H >> 1, :W >> 1],
            ap[0][:H, :W], ap[1][:H >> 1, :W >> 1],
            ap[2][:H >> 1, :W >> 1], pq_stack, lf_stack, lam_stack,
            hp_stack)
        (hdr_d, ctr_d, cfull_d, rec_d, lvl_d, h32_d, c32_d, cfull32_d,
         h64_d, c64_d, cfull64_d, fsel_d) = out
        from ..utils.xfer import fetch
        if recon == "all":
            hdr, ctr, lvl, h32, c32, h64, c64, fsel, rec = fetch(
                hdr_d, ctr_d, lvl_d, h32_d, c32_d, h64_d, c64_d,
                fsel_d, rec_d)
            recons = [split_recon(rec[j], H, W) for j in range(L)]
        else:
            hdr, ctr, lvl, h32, c32, h64, c64, fsel, rec_last = fetch(
                hdr_d, ctr_d, lvl_d, h32_d, c32_d, h64_d, c64_d,
                fsel_d, rec_d[L - 1])
            recons = [None] * (L - 1) + [split_recon(rec_last, H, W)]
        raws = assemble_group_merge(hdr, ctr, cfull_d, lvl, h32, c32,
                                    cfull32_d, h64, c64, cfull64_d)
        for j in range(L):
            raws[j]["filt"] = int(fsel[j])
        return raws, recons


_STEP_FN_CACHE = {}


def _p_step_fn(key):
    """Streaming single-ref P step: encode one frame AND produce the
    padded next-LAST state, so the reference never round-trips to the
    host between frames (the realtime path's device-resident loop)."""
    if key in _STEP_FN_CACHE:
        return _STEP_FN_CACHE[key]
    H, W = key
    base = _p_frame_core((H, W, 1, False))

    def fn(sy, su, sv, ly, lu, lv, ly2, pq_y, pq_u, pq_v, lam, hp):
        hdr, ctr, cfull, rec = base(sy, su, sv, ly[None], lu[None],
                                    lv[None], ly2[None], pq_y, pq_u,
                                    pq_v, lam, hp=hp)
        rec_y = rec[:H]
        rec_u = rec[H:, :W // 2]
        rec_v = rec[H:, W // 2:]
        ny, nu, nv, ny2 = _pad_ref_jnp(rec_y, rec_u, rec_v)
        return hdr, ctr, cfull, rec, ny, nu, nv, ny2

    jitted = jax.jit(fn)
    _STEP_FN_CACHE[key] = jitted
    return jitted


_PREP_FN_CACHE = {}


def prep_ref_state(planes):
    """Upload + pad a host reconstruction into the device-resident
    (ly, lu, lv, ly2) reference state (keyframe bootstrap)."""
    H, W = planes[0].shape[:2]
    fn = _PREP_FN_CACHE.get((H, W))
    if fn is None:
        fn = jax.jit(_pad_ref_jnp)
        _PREP_FN_CACHE[(H, W)] = fn
    return fn(planes[0][:H, :W], planes[1][:H >> 1, :W >> 1],
              planes[2][:H >> 1, :W >> 1])


class DeviceRtEncoder:
    """Streaming P-frame encoder with device-resident reference state:
    per frame, upload the source, run one device step, fetch only the
    header + truncated coefficients.  Reconstruction stays on device
    (deblocking off); fetch it explicitly via `fetch_recon` if needed."""

    def __init__(self, qindex: int):
        self.qindex = qindex
        self.pq_arrs = [_pq_array(Q.build_plane_quant(qindex, 0, 0))
                        for _ in range(3)]
        self.lam = rd_lambda(qindex)
        self.state = None      # (ly, lu, lv, ly2) device arrays
        self._rec_d = None

    def reset_ref(self, planes):
        self.state = prep_ref_state(planes)
        self._rec_d = None

    def encode_frame_async(self, src_planes):
        """Dispatch one frame's device step and announce the result
        copies; returns a handle for `realize()`.  The next frame may
        be dispatched immediately (its reference is the device-resident
        carry), overlapping this frame's D2H with that compute."""
        H, W = src_planes[0].shape[:2]
        fn = _p_step_fn((H, W))
        out = fn(src_planes[0][:H, :W],
                 src_planes[1][:H >> 1, :W >> 1],
                 src_planes[2][:H >> 1, :W >> 1],
                 *self.state, *self.pq_arrs, self.lam,
                 np.int32(1 if self.qindex < 128 else 0))
        hdr_d, ctr_d, cfull_d, rec_d, ny, nu, nv, ny2 = out
        self.state = (ny, nu, nv, ny2)
        self._rec_d = rec_d
        for a in (hdr_d, ctr_d):
            a.copy_to_host_async()
        return (hdr_d, ctr_d, cfull_d)

    @staticmethod
    def realize(handle):
        hdr_d, ctr_d, cfull_d = handle
        from ..utils.xfer import fetch
        hdr, ctr = fetch(hdr_d, ctr_d)
        return assemble_res(
            hdr, ctr, lambda idx: np.asarray(cfull_d[jnp.asarray(idx)]))

    def encode_frame(self, src_planes):
        return self.realize(self.encode_frame_async(src_planes))

    def fetch_recon(self, H, W):
        from ..utils.xfer import fetch
        return split_recon(fetch(self._rec_d), H, W)


class DeviceInterEncoder:
    """Whole-frame batched P-frame encode at fixed 16x16 blocks, over
    one or two reference frames."""

    def __init__(self, qindex: int):
        self.qindex = qindex
        self.pq_arrs = []
        for (dcd, acd) in ((0, 0), (0, 0), (0, 0)):
            self.pq_arrs.append(_pq_array(
                Q.build_plane_quant(qindex, dcd, acd)))
        self.lam = rd_lambda(qindex)

    def encode_frame(self, src_planes, ref_planes_list):
        """src_planes: mi-aligned (y, u, v); ref_planes_list: list of
        visible (y, u, v) reference frames (1 or 2).  Returns dict of
        per-block results + recon (16x16-leaf view; merged levels are
        in self.res_raw)."""
        raw = self.encode_frame_raw(src_planes, ref_planes_list)
        return pack_frame_results(raw["r16"], src_planes[0].shape[1])

    def encode_frame_raw(self, src_planes, ref_planes_list):
        """Like encode_frame but returns the raw result dict (r16 /
        r32 / r64 raster buffers + the lvl partition map) that the
        emitters consume directly — callers that use the C walker skip
        the per-block dict packing entirely."""
        H, W = src_planes[0].shape[:2]
        assert H % 16 == 0 and W % 16 == 0
        n_refs = len(ref_planes_list)
        fn = _p_frame_fn((H, W, n_refs, True, False))
        refs_y, refs_u, refs_v, refs_y2 = [], [], [], []
        for rp in ref_planes_list:
            py = np.pad(rp[0], PADR, mode="edge").astype(np.uint8)
            refs_y.append(py)
            refs_u.append(np.pad(rp[1], PADR, mode="edge"))
            refs_v.append(np.pad(rp[2], PADR, mode="edge"))
            y2 = py.astype(np.int32)
            h2 = (y2.shape[0] // 2) * 2
            w2 = (y2.shape[1] // 2) * 2
            y2 = y2[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).sum((1, 3))
            refs_y2.append(y2)
        (hdr_d, ctr_d, cfull_d, rec_d, lvl_d, h32_d, c32_d, cfull32_d,
         h64_d, c64_d, cfull64_d, _fsel_d) = fn(
            jnp.asarray(src_planes[0][:H, :W]),
            jnp.asarray(src_planes[1][:H >> 1, :W >> 1]),
            jnp.asarray(src_planes[2][:H >> 1, :W >> 1]),
            jnp.asarray(np.stack(refs_y)),
            jnp.asarray(np.stack(refs_u)),
            jnp.asarray(np.stack(refs_v)),
            jnp.asarray(np.stack(refs_y2)),
            self.pq_arrs[0], self.pq_arrs[1], self.pq_arrs[2],
            self.lam, np.int32(1 if self.qindex < 128 else 0))
        from ..utils.xfer import fetch
        hdr, ctr, lvl, h32, c32, h64, c64, rec = fetch(
            hdr_d, ctr_d, lvl_d, h32_d, c32_d, h64_d, c64_d, rec_d)
        self.recon = split_recon(rec, H, W)
        raw = assemble_group_merge(
            hdr[None], ctr[None], cfull_d[None], lvl[None], h32[None],
            c32[None], cfull32_d[None], h64[None], c64[None],
            cfull64_d[None])[0]
        self.res_raw = raw
        return raw
