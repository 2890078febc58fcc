"""Wavefront-batched all-intra encoding on the device (JAX).

Batched recast of the encoder hot loop (SURVEY §7 hard part (c)): blocks
on the same anti-diagonal have no prediction dependency (top/left/above-left
only for the non-directional mode set), so each wave encodes as one batched
tensor op: gather edges -> 7 intra predictions -> batched integer DCT ->
vectorized quantize -> RD mode pick -> exact inverse -> scatter recon.
The per-tile entropy coding stays on host (native C runtime).

Bit-exactness contract: prediction, dequant and inverse transform match the
normative decoder exactly (int ops; verified against the host reference),
so host emit + stock aomdec reproduce the device recon.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..bitstream import constants as c
from ..common import quant as Q
from ..common.intra import SMOOTH_WEIGHTS
from . import txfm_jax as TJ

# candidate modes (no edge-filter dependency; exact without TR/BL)
WAVE_MODES = (c.DC_PRED, c.V_PRED, c.H_PRED, c.SMOOTH_PRED,
              c.SMOOTH_V_PRED, c.SMOOTH_H_PRED, c.PAETH_PRED)


def _predict_modes(above, left, al, have_top, have_left, B):
    """above/left: (N, B) int32, al: (N,), flags (N,) bool.
    Returns (N, 7, B, B) uint8-range int32 predictions."""
    N = above.shape[0]
    a = above.astype(jnp.int32)
    lf = left.astype(jnp.int32)
    # DC
    s_a = a.sum(-1)
    s_l = lf.sum(-1)
    log2b = B.bit_length() - 1
    dc_both = (s_a + s_l + B) >> (log2b + 1)
    dc_top = (s_a + (B >> 1)) >> log2b
    dc_left = (s_l + (B >> 1)) >> log2b
    dc = jnp.where(have_top & have_left, dc_both,
                   jnp.where(have_top, dc_top,
                             jnp.where(have_left, dc_left, 128)))
    dc_pred = jnp.broadcast_to(dc[:, None, None], (N, B, B))
    v_pred = jnp.broadcast_to(a[:, None, :], (N, B, B))
    h_pred = jnp.broadcast_to(lf[:, :, None], (N, B, B))
    # SMOOTH family
    w = jnp.asarray(SMOOTH_WEIGHTS[B], dtype=jnp.int32)
    below = lf[:, B - 1]
    right = a[:, B - 1]
    sm = (w[None, :, None] * a[:, None, :]
          + (256 - w)[None, :, None] * below[:, None, None]
          + w[None, None, :] * lf[:, :, None]
          + (256 - w)[None, None, :] * right[:, None, None])
    sm_pred = (sm + 256) >> 9
    smv = (w[None, :, None] * a[:, None, :]
           + (256 - w)[None, :, None] * below[:, None, None])
    smv_pred = (smv + 128) >> 8
    smh = (w[None, None, :] * lf[:, :, None]
           + (256 - w)[None, None, :] * right[:, None, None])
    smh_pred = (smh + 128) >> 8
    # PAETH
    tl = al.astype(jnp.int32)[:, None, None]
    base = a[:, None, :] + lf[:, :, None] - tl
    pl = jnp.abs(base - lf[:, :, None])
    pt = jnp.abs(base - a[:, None, :])
    ptl = jnp.abs(base - tl)
    paeth = jnp.where((pl <= pt) & (pl <= ptl),
                      jnp.broadcast_to(lf[:, :, None], base.shape),
                      jnp.where(pt <= ptl,
                                jnp.broadcast_to(a[:, None, :], base.shape),
                                jnp.broadcast_to(tl, base.shape)))
    return jnp.stack([dc_pred, v_pred, h_pred, sm_pred, smv_pred, smh_pred,
                      paeth], axis=1)


def _quantize_jnp(coeff, pq, log_scale, dc_mask):
    """Vectorized aom_quantize_b (coeff (..., n) int; dc_mask (n,) bool).
    Returns (qcoeff, dqcoeff_abs_signed)."""
    zbin = jnp.where(dc_mask, pq.zbin[0], pq.zbin[1])
    rnd = jnp.where(dc_mask, pq.round[0], pq.round[1])
    quant = jnp.where(dc_mask, pq.quant[0], pq.quant[1])
    qshift = jnp.where(dc_mask, pq.quant_shift[0], pq.quant_shift[1])
    deq = jnp.where(dc_mask, pq.dequant[0], pq.dequant[1])
    if log_scale:
        zbin = (zbin + (1 << log_scale >> 1)) >> log_scale
        rnd = (rnd + (1 << log_scale >> 1)) >> log_scale
    # inline XLA: this runs inside large jitted pipelines where XLA
    # fuses it with the surrounding transform math
    ac = jnp.abs(coeff)
    sign = jnp.where(coeff < 0, -1, 1)
    above = ac >= zbin
    tmp = jnp.clip(ac + rnd, -32768, 32767)
    tmp32 = ((((tmp * quant) >> 16) + tmp) * qshift) >> (16 - log_scale)
    tmp32 = jnp.where(above, tmp32, 0)
    qcoeff = sign * tmp32
    dq = (tmp32 * deq) >> log_scale
    dqcoeff = sign * dq
    return qcoeff.astype(jnp.int32), dqcoeff.astype(jnp.int32)


def _est_bits(qcoeff, scan_order):
    """Crude token-bit estimate (matches the host RD estimator)."""
    aq = jnp.abs(qcoeff).astype(jnp.float32)
    aq_scan = aq[..., scan_order]
    nz = aq_scan > 0
    n = aq_scan.shape[-1]
    idx = jnp.arange(n)
    eob = jnp.max(jnp.where(nz, idx + 1, 0), axis=-1)
    nnz = nz.sum(-1)
    level_bits = jnp.where(nz, 1.7 + 2.0 * jnp.log2(aq_scan + 1.0),
                           0.0).sum(-1)
    bits = 2.0 + 0.9 * jnp.log2(eob + 1.0) + 0.55 * (eob - nnz) + level_bits
    return jnp.where(eob == 0, 0.6, bits), eob


_FRAME_FN_CACHE = {}


class _PQ:
    """Quantizer params as traced arrays (shared jit across qindex)."""

    def __init__(self, arr):
        (self.zbin, self.round, self.quant, self.quant_shift,
         self.dequant) = [tuple(row) for row in arr]


def _pq_array(pq):
    return np.array([pq.zbin, pq.round, pq.quant, pq.quant_shift,
                     pq.dequant], np.int32)


class WavefrontEncoder:
    """Whole-frame batched all-intra encode at fixed block size B=16."""

    B = 16

    def __init__(self, qindex: int, lam: float):
        self.qindex = qindex
        self.lam = lam
        self.pq = [Q.build_plane_quant(qindex, 0, 0),
                   Q.build_plane_quant(qindex, 0, 0),
                   Q.build_plane_quant(qindex, 0, 0)]

    # ---- whole-frame jitted fn (cached per geometry, qindex traced) ----

    def _wave_fn(self, key):
        if key in _FRAME_FN_CACHE:
            return _FRAME_FN_CACHE[key]
        max_n = key[-1]
        B = self.B
        Bc = B // 2
        from ..bitstream import tables
        # numpy closure constants (see ops/inter_tpu.FILT8)
        scan_y = np.asarray(tables.scan(c.TX_16X16, c.DCT_DCT),
                            dtype=np.int32)
        scan_c = np.asarray(tables.scan(c.TX_8X8, c.DCT_DCT),
                            dtype=np.int32)
        dc_mask_y = (np.arange(B * B) == 0)
        dc_mask_c = (np.arange(Bc * Bc) == 0)

        def plane_encode(recon, src, ys, xs, valid, B_, scan, dc_mask,
                         pqp, tx_size, n_modes, lam):
            # gather edges from a 1-padded copy (index k+1 == recon k)
            rp = jnp.pad(recon, ((1, 0), (1, 0)), constant_values=0)

            def gather(y, x):
                above = jax.lax.dynamic_slice(rp, (y, x + 1), (1, B_))[0]
                leftc = jax.lax.dynamic_slice(rp, (y + 1, x), (B_, 1))[:, 0]
                al = jax.lax.dynamic_slice(rp, (y, x), (1, 1))[0, 0]
                first_l = jax.lax.dynamic_slice(rp, (y + 1, x), (1, 1))[0, 0]
                first_a = jax.lax.dynamic_slice(rp, (y, x + 1), (1, 1))[0, 0]
                blk = jax.lax.dynamic_slice(src, (y, x), (B_, B_))
                return above, leftc, al, first_l, first_a, blk

            above, leftc, al, first_l, first_a, blk = \
                jax.vmap(gather)(ys, xs)
            have_top = ys > 0
            have_left = xs > 0
            # edge fill rules (reconintra.c:1309 defaults)
            above_f = jnp.where(
                have_top[:, None], above,
                jnp.where(have_left[:, None],
                          jnp.broadcast_to(first_l[:, None], above.shape),
                          jnp.full_like(above, 127)))
            left_f = jnp.where(
                have_left[:, None], leftc,
                jnp.where(have_top[:, None],
                          jnp.broadcast_to(first_a[:, None], leftc.shape),
                          jnp.full_like(leftc, 129)))
            al_f = jnp.where(
                have_top & have_left, al,
                jnp.where(have_top, first_a,
                          jnp.where(have_left, first_l, 128)))
            preds = _predict_modes(above_f, left_f, al_f, have_top,
                                   have_left, B_)[:, :n_modes]
            M = preds.shape[1]
            resid = blk[:, None].astype(jnp.int32) - preds
            coeff = TJ.fwd_txfm2d_batched(
                resid.reshape(-1, B_, B_), tx_size, c.DCT_DCT)
            log_scale = 1 if B_ * B_ > 256 else 0
            qcoeff, dqcoeff = _quantize_jnp(coeff, pqp, log_scale, dc_mask)
            bits, eob = _est_bits(qcoeff, scan)
            recon_all = TJ.inv_txfm2d_add_batched(
                dqcoeff, preds.reshape(-1, B_, B_).astype(jnp.uint8),
                tx_size, c.DCT_DCT)
            recon_all = jnp.where((eob > 0)[:, None, None], recon_all,
                                  preds.reshape(-1, B_, B_).astype(
                                      jnp.uint8))
            d = blk[:, None].astype(jnp.int32) - \
                recon_all.reshape(-1, M, B_, B_).astype(jnp.int32)
            sse = (d * d).sum((-1, -2))
            cost = sse.astype(jnp.float32) + \
                jnp.float32(lam) * bits.reshape(-1, M)
            best = jnp.argmin(cost, axis=1)  # (N,)
            sel = best + jnp.arange(best.shape[0]) * M
            q_best = qcoeff.reshape(-1, B_ * B_)[sel]
            eob_best = eob[sel]
            recon_best = recon_all[sel]
            # scatter recon
            # scatter recon; padded lanes get out-of-bounds coords, dropped
            ys_s = jnp.where(valid, ys, recon.shape[0]).astype(jnp.int32)
            rows = ys_s[:, None, None] + \
                jnp.arange(B_, dtype=jnp.int32)[None, :, None]
            cols = xs.astype(jnp.int32)[:, None, None] + \
                jnp.arange(B_, dtype=jnp.int32)[None, None, :]
            recon = recon.at[rows, cols].set(recon_best, mode="drop")
            return recon, best, q_best, eob_best

        def frame_fn(src_y, src_u, src_v, wave_ys, wave_xs, wave_valid,
                     pq_arrs, lam):
            """Whole-frame encode: lax.fori_loop over waves on device."""
            pq = [_PQ(a) for a in pq_arrs]
            H, W = src_y.shape
            n_waves = wave_ys.shape[0]
            recon_y = jnp.zeros((H, W), jnp.uint8)
            recon_u = jnp.zeros((H // 2, W // 2), jnp.uint8)
            recon_v = jnp.zeros((H // 2, W // 2), jnp.uint8)
            out_best = jnp.zeros((n_waves, max_n), jnp.int32)
            out_qy = jnp.zeros((n_waves, max_n, B * B), jnp.int32)
            out_qu = jnp.zeros((n_waves, max_n, Bc * Bc), jnp.int32)
            out_qv = jnp.zeros((n_waves, max_n, Bc * Bc), jnp.int32)
            out_eob = jnp.zeros((n_waves, max_n, 3), jnp.int32)

            def body(d, carry):
                (ry, ru, rv, ob, oqy, oqu, oqv, oe) = carry
                ys = wave_ys[d]
                xs = wave_xs[d]
                valid = wave_valid[d]
                ry, best, qy, eoby = plane_encode(
                    ry, src_y, ys, xs, valid, B, scan_y, dc_mask_y,
                    pq[0], c.TX_16X16, len(WAVE_MODES), lam)
                ru, _, qu, eobu = plane_encode(
                    ru, src_u, ys // 2, xs // 2, valid, Bc, scan_c,
                    dc_mask_c, pq[1], c.TX_8X8, 1, lam)
                rv, _, qv, eobv = plane_encode(
                    rv, src_v, ys // 2, xs // 2, valid, Bc, scan_c,
                    dc_mask_c, pq[2], c.TX_8X8, 1, lam)
                ob = ob.at[d].set(best)
                oqy = oqy.at[d].set(qy)
                oqu = oqu.at[d].set(qu)
                oqv = oqv.at[d].set(qv)
                oe = oe.at[d].set(jnp.stack([eoby, eobu, eobv], axis=-1))
                return (ry, ru, rv, ob, oqy, oqu, oqv, oe)

            (ry, ru, rv, ob, oqy, oqu, oqv, oe) = jax.lax.fori_loop(
                0, n_waves, body,
                (recon_y, recon_u, recon_v, out_best, out_qy, out_qu,
                 out_qv, out_eob))
            # ship exactly two D2H payloads (one int16 result buffer +
            # one uint8 recon)
            res = jnp.concatenate([
                ob.astype(jnp.int16)[..., None],
                oe.astype(jnp.int16),
                oqy.astype(jnp.int16),
                oqu.astype(jnp.int16),
                oqv.astype(jnp.int16)], axis=-1)
            rec = jnp.concatenate(
                [ry, jnp.concatenate([ru, rv], axis=1)], axis=0)
            return res, rec

        fn = jax.jit(frame_fn)
        _FRAME_FN_CACHE[key] = fn
        return fn

    def _wave_fn_batched(self, key):
        """vmap of the whole-frame program over a frame batch: the
        sequential wave loop is the cost driver (per-step overhead), so
        N frames ride the SAME 2*sqrt-ish wave steps for ~the price of
        one (frames are independent; only the geometry is shared)."""
        bkey = key + ("batched",)
        if bkey in _FRAME_FN_CACHE:
            return _FRAME_FN_CACHE[bkey]
        base = self._wave_fn(key)
        fn = jax.jit(jax.vmap(base,
                              in_axes=(0, 0, 0, None, None, None, None,
                                       None)))
        _FRAME_FN_CACHE[bkey] = fn
        return fn

    def encode_frames_raw(self, frame_list):
        """Batched multi-frame encode: ONE dispatch + ONE pipelined
        fetch for a list of same-geometry (y, u, v) frames.  Returns
        (per-frame results dicts, per-frame res390 or None, per-frame
        recon tuples)."""
        B = self.B
        ys = np.stack([np.asarray(f[0]) for f in frame_list])
        us = np.stack([np.asarray(f[1]) for f in frame_list])
        vs = np.stack([np.asarray(f[2]) for f in frame_list])
        N, H, W = ys.shape
        assert H % B == 0 and W % B == 0
        (wave_ys, wave_xs, wave_valid, waves, nbr, nbc) = \
            self._wave_geometry(H, W)
        fn = self._wave_fn_batched((H, W, len(waves),
                                    wave_ys.shape[1]))
        pq_arrs = tuple(jnp.asarray(_pq_array(p)) for p in self.pq)
        res, rec = fn(jnp.asarray(ys), jnp.asarray(us), jnp.asarray(vs),
                      jnp.asarray(wave_ys), jnp.asarray(wave_xs),
                      jnp.asarray(wave_valid), pq_arrs,
                      jnp.float32(self.lam))
        from ..utils.xfer import fetch
        res, rec = fetch(res, rec)
        out = []
        for i in range(N):
            out.append(self._unpack(res[i], rec[i], waves, nbr, nbc,
                                    H, W))
        return out

    def _wave_geometry(self, H, W):
        B = self.B
        nbr, nbc = H // B, W // B
        waves = []
        for d in range(nbr + nbc - 1):
            waves.append([(r, d - r) for r in range(max(0, d - nbc + 1),
                                                    min(nbr, d + 1))])
        max_n = max(len(b) for b in waves)
        n_waves = len(waves)
        wave_ys = np.zeros((n_waves, max_n), np.int32)
        wave_xs = np.zeros((n_waves, max_n), np.int32)
        wave_valid = np.zeros((n_waves, max_n), bool)
        for d, blocks in enumerate(waves):
            for i, (r, cc) in enumerate(blocks):
                wave_ys[d, i] = r * B
                wave_xs[d, i] = cc * B
                wave_valid[d, i] = True
        return wave_ys, wave_xs, wave_valid, waves, nbr, nbc

    def _unpack(self, res, rec, waves, nbr, nbc, H, W):
        """One frame's packed device outputs -> (results dict, res390,
        recon planes)."""
        B = self.B
        Bq = B * B
        Bcq = (B // 2) * (B // 2)
        results = {}
        for d, blocks in enumerate(waves):
            for i, (r, cc) in enumerate(blocks):
                row = res[d, i]
                results[(r, cc)] = dict(
                    y_mode=WAVE_MODES[int(row[0])],
                    qy=row[4:4 + Bq],
                    qu=row[4 + Bq:4 + Bq + Bcq],
                    qv=row[4 + Bq + Bcq:4 + Bq + 2 * Bcq],
                    eoby=int(row[1]), eobu=int(row[2]),
                    eobv=int(row[3]))
        res390 = None
        if B == 16:
            n_waves = len(waves)
            max_n = res.shape[1]
            bidx = np.full((n_waves, max_n), -1, np.int64)
            for d, blocks in enumerate(waves):
                for i, (r, cc) in enumerate(blocks):
                    bidx[d, i] = r * nbc + cc
            vmask = bidx >= 0
            rows = res[vmask].astype(np.int16)
            tgt = bidx[vmask]
            r390 = np.zeros((nbr * nbc, 390), np.int16)
            modes = np.asarray(WAVE_MODES, np.int16)
            r390[tgt, 0] = modes[rows[:, 0]]
            r390[tgt, 1:4] = rows[:, 1:4]
            r390[tgt, 6:262] = rows[:, 4:260]
            r390[tgt, 262:326] = rows[:, 260:324]
            r390[tgt, 326:390] = rows[:, 324:388]
            res390 = r390
        recon = (rec[:H], rec[H:, :W // 2], rec[H:, W // 2:])
        return results, res390, recon

    def encode_frame(self, src_planes):
        """src_planes: (y, u, v) padded to B multiples.  Returns per-block
        results dict keyed by (block_row, block_col)."""
        (results, res390, recon), = self.encode_frames_raw([src_planes])
        self.res390 = res390
        self.recon = recon
        return results
