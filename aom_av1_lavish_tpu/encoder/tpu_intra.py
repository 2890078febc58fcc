"""Device-batched all-intra encoder: wavefront device encode + host emit.

The compute-heavy per-block work (prediction, transforms, quantization,
mode RD) runs as batched JAX waves on device (ops/wavefront.py); the host
walks the fixed 16x16 partition tree and feeds the native entropy coder.
This is the "fast" preset; the Python RD encoder (lossy.py) is the
"quality" preset until partition RDO lands on device.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c
from ..common import blockd
from ..common import txtype as TT
from .lossy import LossyAllIntraEncoder, make_lossy_frame_header
from .encoder import make_sequence_header


class TpuAllIntraEncoder(LossyAllIntraEncoder):
    """Fixed 16x16 blocks, device wavefront encode (7-mode RD)."""

    def __init__(self, sh, fh, use_native=None):
        super().__init__(sh, fh, use_native=use_native,
                         block_size=c.BLOCK_16X16)
        self._results = None

    def encode_frame(self, planes, use_jax: bool = True) -> bytes:
        from ..ops.wavefront import WavefrontEncoder
        w = self.mi_cols * 4
        h = self.mi_rows * 4
        assert w % 16 == 0 and h % 16 == 0, \
            "device preset needs a 16px-aligned mi grid " \
            "(use lossy.py otherwise)"
        self._wave = WavefrontEncoder(self.fh.base_q_idx, self.lam)
        self._results = None
        return super(LossyAllIntraEncoder, self).encode_frame(
            planes, use_jax=False)

    # device encode happens lazily once source planes are padded
    def _ensure_device_encode(self):
        if self._results is None:
            ext = getattr(self, "_external_wave", None)
            if ext is not None:
                # precomputed by a batched multi-frame device run
                self._results, self._wave.res390, rec = ext
            else:
                self._results = self._wave.encode_frame(
                    [self.src[0][:self.mi_rows * 4, :self.mi_cols * 4],
                     self.src[1][:self.mi_rows * 2, :self.mi_cols * 2],
                     self.src[2][:self.mi_rows * 2, :self.mi_cols * 2]])
                rec = self._wave.recon
            ry, ru, rv = rec
            self.recon[0][:ry.shape[0], :ry.shape[1]] = ry
            self.recon[1][:ru.shape[0], :ru.shape[1]] = ru
            self.recon[2][:rv.shape[0], :rv.shape[1]] = rv

    def _filter_recon(self, search: bool = True):
        """KEY frames from the wavefront path are uniform 16x16 with
        TX_16X16/TX_8X8, so the in-loop deblock collapses to the device
        fixed-grid filter at the header's q-derived level
        (LPF_PICK_FROM_Q) — replacing the host level search + numpy
        filter, which costs ~1.7 s/frame at 1080p.  Falls back to the
        general host path for cdef/lr/hbd/non-420 configs."""
        fh, sh = self.fh, self.sh
        h, w = self.mi_rows * 4, self.mi_cols * 4
        # device deblock only where the host filter dominates (~1.7 s
        # at 1080p); at small sizes the extra device round trip
        # serializes the wavefront pipeline and loses badly
        if (h * w > 1280 * 720
                and fh.base_q_idx > 0 and not sh.enable_cdef
                and not sh.enable_restoration and self.num_planes == 3
                and self.bd == 8 and self.ss_x and self.ss_y
                and not fh.loop_filter_delta_enabled
                and h % 16 == 0 and w % 16 == 0
                and fh.filter_level[0] > 0):
            from ..ops.deblock_jnp import deblock_fixed16
            from ..utils.xfer import fetch
            y, u, v = deblock_fixed16(
                self.recon[0][:h, :w],
                self.recon[1][:h >> 1, :w >> 1],
                self.recon[2][:h >> 1, :w >> 1],
                fh.filter_level[0], fh.filter_level_u,
                fh.filter_level_v, sharpness=fh.sharpness_level)
            y, u, v = fetch(y, u, v)
            self.recon[0][:h, :w] = y
            self.recon[1][:h >> 1, :w >> 1] = u
            self.recon[2][:h >> 1, :w >> 1] = v
            return
        super()._filter_recon(search=search)

    # --- native tile fast path -----------------------------------------

    def _native_tile_ok(self) -> bool:
        """The C walker (runtime/inter_tile.c avl_encode_intra16_tile)
        covers exactly the restricted KEY syntax this encoder emits."""
        if self.use_native is False \
                or getattr(self._wave, "res390", None) is None:
            return False
        from ..runtime import native_available
        fh, sh = self.fh, self.sh
        return (native_available()
                and fh.tx_mode == c.TX_MODE_LARGEST
                and not fh.delta_q_present
                and not fh.segmentation_enabled
                and not self.intrabc and not self.screen
                and not sh.enable_filter_intra
                and fh.tile_cols_log2 == 0 and fh.tile_rows_log2 == 0
                and self.sb_mi == 16
                and self.num_planes == 3 and self.bd == 8
                and self.mi_rows % 4 == 0 and self.mi_cols % 4 == 0)

    def _encode_tile(self) -> bytes:
        self._ensure_device_encode()
        if not self._native_tile_ok():
            return super()._encode_tile()
        from ..bitstream.tables import FrameContext
        from ..runtime import encode_intra16_tile
        fc = (self.fc0.copy() if getattr(self, "fc0", None) is not None
              else FrameContext(self.fh.base_q_idx))
        data = encode_intra16_tile(
            fc, self._wave.res390, self.mi_rows, self.mi_cols,
            sb_mi=self.sb_mi,
            reduced_tx_set=int(self.fh.reduced_tx_set))
        self.fc = fc
        # grid bookkeeping for the frame pipeline (deblock level search
        # reads mi_bsize; CDEF search reads mi_skip)
        res = self._wave.res390
        nby, nbx = self.mi_rows // 4, self.mi_cols // 4
        skip_blk = ((res[:, 1] == 0) & (res[:, 2] == 0)
                    & (res[:, 3] == 0)).reshape(nby, nbx)
        self.mi_skip[:nby * 4, :nbx * 4] = np.repeat(
            np.repeat(skip_blk, 4, 0), 4, 1)
        self.mi_bsize[:nby * 4, :nbx * 4] = c.BLOCK_16X16
        self.mi_mode[:nby * 4, :nbx * 4] = np.repeat(
            np.repeat(res[:, 0].reshape(nby, nbx), 4, 0), 4, 1)
        return data

    def _search(self, mi_row, mi_col, bsize):
        self._ensure_device_encode()
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return 0.0, None
        if bsize == c.BLOCK_16X16:
            return 0.0, ("NONE", mi_row, mi_col, bsize,
                         [self._leaf(mi_row, mi_col)])
        hbs = blockd.mi_size_wide(bsize) // 2
        sub = blockd.partition_subsize(bsize, c.PARTITION_SPLIT)
        kids = []
        for (r, cc) in ((mi_row, mi_col), (mi_row, mi_col + hbs),
                        (mi_row + hbs, mi_col), (mi_row + hbs,
                                                 mi_col + hbs)):
            _, k = self._search(r, cc, sub)
            kids.append(k)
        return 0.0, ("SPLIT", mi_row, mi_col, bsize, kids)

    def _leaf(self, mi_row, mi_col):
        res = self._results[(mi_row // 4, mi_col // 4)]
        y_mode = res["y_mode"]
        # luma tx type symbol (TX_16X16 -> DTT4_IDTX set, DCT_DCT coded)
        st = TT.ext_tx_set_type(c.TX_16X16, False,
                                bool(self.fh.reduced_tx_set))
        tx_type_sym = None
        if TT.NUM_EXT_TX_SET[st] > 1:
            eset = TT.intra_ext_tx_idx(st)
            sqr = c.TX_SIZE_SQR[c.TX_16X16]
            sym = TT.EXT_TX_IND[st][c.DCT_DCT]
            tx_type_sym = (("intra_ext_tx_cdf", eset, sqr, y_mode), sym,
                           TT.NUM_EXT_TX_SET[st])
        py = mi_row * 4
        px = mi_col * 4
        txbs = [dict(plane=0, tx_size=c.TX_16X16, tx_type=c.DCT_DCT,
                     tx_type_sym=tx_type_sym, qcoeff=res["qy"],
                     eob=res["eoby"], plane_bsize=c.BLOCK_16X16,
                     py=py, px=px, recon=None, acol=px >> 2, lrow=py >> 2)]
        for plane, (q, eob) in ((1, (res["qu"], res["eobu"])),
                                (2, (res["qv"], res["eobv"]))):
            cx, cy = px >> 1, py >> 1
            txbs.append(dict(
                plane=plane, tx_size=c.TX_8X8,
                tx_type=TT.chroma_intra_tx_type(c.DC_PRED, c.TX_8X8, False),
                tx_type_sym=None, qcoeff=q, eob=eob,
                plane_bsize=c.BLOCK_8X8, py=cy, px=cx,
                recon=None, acol=cx >> 2, lrow=cy >> 2))
        return dict(mi_row=mi_row, mi_col=mi_col, bsize=c.BLOCK_16X16,
                    y_mode=y_mode, uv_mode=c.DC_PRED, cfl=None, txbs=txbs,
                    is_chroma_ref=True)


def encode_tpu_ivf(path: str, frames, width: int, height: int,
                   qindex: int = 60, fps=(30, 1)) -> None:
    """All frames ride ONE batched device program (the wavefront loop's
    per-step cost is fixed, so N frames cost ~one frame's steps), then
    emit per frame through the native tile walker."""
    from ..bitstream.ivf import write_ivf
    from ..ops.wavefront import WavefrontEncoder
    sh = make_sequence_header(width, height)
    # probe one encoder for the padded geometry + lambda
    fh0 = make_lossy_frame_header(sh, qindex)
    probe = TpuAllIntraEncoder(sh, fh0)
    wave = WavefrontEncoder(fh0.base_q_idx, probe.lam)
    probe.pad_planes(frames[0])
    h = probe.mi_rows * 4
    w = probe.mi_cols * 4
    padded = []
    for f in frames:
        e = TpuAllIntraEncoder(sh, make_lossy_frame_header(sh, qindex))
        e.pad_planes(f)
        padded.append([e.src[0][:h, :w], e.src[1][:h >> 1, :w >> 1],
                       e.src[2][:h >> 1, :w >> 1]])
    raw = wave.encode_frames_raw(padded)
    payloads = []
    for i, f in enumerate(frames):
        fh = make_lossy_frame_header(sh, qindex)
        enc = TpuAllIntraEncoder(sh, fh)
        enc._external_wave = raw[i]
        payloads.append((enc.encode_frame(f), i))
    write_ivf(path, payloads, width, height, fps[0], fps[1])
