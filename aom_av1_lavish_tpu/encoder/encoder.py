"""Lossless all-intra AV1 encoder — host reference path.

Produces conformant AV1 bitstreams (key frames, 8-bit 4:2:0, lossless WHT
path) decodable bit-exactly by stock aomdec and by our own decoder
(reference behavior being mirrored: av1/encoder/bitstream.c write path,
encodetxb.c coefficient coding, encodeframe.c block walk).

This is the correctness spine of SURVEY.md §7 step 3; the device (JAX/Pallas)
encode path batches the per-block math (prediction, WHT, tokenization) and
feeds the same per-tile symbol stream writer.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c
from ..bitstream import headers as H
from ..bitstream.bits import BitWriter
from ..bitstream.entropy import RangeEncoder
from ..bitstream.ivf import write_ivf
from ..bitstream.tables import FrameContext
from ..common import blockd, coeffs as CF, intra
from ..common.txfm import fwht4x4, iwht4x4

INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]
PARTITION_PLOFFSET = 4


def pack_tile_group(tiles: list, tile_size_bytes: int) -> bytes:
    """Concatenate per-tile bytestreams into tile-group payload bytes
    (spec 5.11.1 inside an OBU_FRAME: tile_start_and_end_present_flag=0,
    tile_size_minus_1 before every tile but the last)."""
    if len(tiles) == 1:
        return tiles[0]
    out = bytearray(b"\x00")  # start/end flag + byte alignment
    for t in tiles[:-1]:
        out += (len(t) - 1).to_bytes(tile_size_bytes, "little")
        out += t
    out += tiles[-1]
    return bytes(out)



def _cul_level_of(qcoeff: np.ndarray) -> int:
    """Entropy-context value from quantized coeffs (matches the tokenizer:
    min(63, sum|q|) plus dc-sign bits)."""
    s = int(np.abs(qcoeff).sum())
    if s == 0 and qcoeff[0] == 0:
        cul = 0
    else:
        cul = min(CF.COEFF_CONTEXT_MASK, s)
    return CF.set_dc_sign(cul, int(qcoeff[0]))


class PySink:
    """Reference symbol sink: Python range coder + FrameContext."""

    def __init__(self, fc):
        self.fc = fc
        self.wr = RangeEncoder()

    def symbol(self, sym, nsymbs, name, *idx, adapt=True):
        cdf = self.fc._d[name]
        for i in idx:
            cdf = cdf[i]
        if adapt:
            self.wr.encode_symbol_adapt(sym, cdf, nsymbs)
        else:
            self.wr.encode_symbol(sym, cdf, nsymbs)

    def bit(self, b):
        self.wr.encode_bit(int(b))

    def gather_split(self, sym, ctx, is_128, horz_alike):
        from ..decoder.decoder import FrameDecoder
        cdf = self.fc.partition_cdf[ctx]
        bsize = c.BLOCK_128X128 if is_128 else c.BLOCK_64X64
        g = FrameDecoder._gather_split_cdf(FrameDecoder, cdf, bsize,
                                           horz_alike)
        self.wr.encode_symbol(sym, g, 2)

    def txb(self, qcoeff, plane, skip_ctx, dc_sign_ctx,
            tx_size=c.TX_4X4, tx_type=c.DCT_DCT, tx_type_sym=None):
        writer = None
        if tx_type_sym is not None:
            name_idx, sym, nsymbs = tx_type_sym

            def writer():
                cdf = self.fc._d[name_idx[0]]
                for i in name_idx[1:]:
                    cdf = cdf[i]
                self.wr.encode_symbol_adapt(sym, cdf, nsymbs)
        return CF.write_coeffs_txb(self.wr, self.fc, qcoeff, plane,
                                   tx_size, tx_type, skip_ctx,
                                   dc_sign_ctx, tx_type_writer=writer)

    def finish(self):
        return self.wr.done()


class NativeSink:
    """Native symbol sink: accumulate ops, replay in C (runtime/)."""

    def __init__(self, fc):
        from ..runtime import FcArena, OpStream
        self.fc = fc
        self.arena = FcArena(fc)
        self.os = OpStream(self.arena)

    def symbol(self, sym, nsymbs, name, *idx, adapt=True):
        self.os.symbol(sym, name, *idx, nsymbs=nsymbs, adapt=adapt)

    def bit(self, b):
        self.os.bit(int(b))

    def gather_split(self, sym, ctx, is_128, horz_alike):
        self.os.gather_split(sym, ctx, is_128, horz_alike)

    def txb(self, qcoeff, plane, skip_ctx, dc_sign_ctx,
            tx_size=c.TX_4X4, tx_type=c.DCT_DCT, tx_type_sym=None):
        plane_type = int(plane > 0)
        adj = CF.adjusted_tx_size(tx_size)
        txs_ctx = CF.txsize_entropy_ctx(tx_size)
        eob_ms = CF.eob_multi_size(tx_size)
        cdfset = self.os.cdfset_for(plane_type, txs_ctx, eob_ms)
        scan_off = self.os.scan_offset(adj, tx_type)
        if tx_type_sym is not None:
            name_idx, sym, nsymbs = tx_type_sym
            off = self.arena.offset(*name_idx)
            self.os.ops.append((4, off, nsymbs, int(sym), 1, 0, 0, 0))
        w = c.TX_WIDTH[adj]
        h = c.TX_HEIGHT[adj]
        bhl = h.bit_length() - 1
        tx_class = CF.TX_TYPE_TO_CLASS[tx_type]
        # pack raw dims for the nz-offset rect rule (64-dim sizes differ)
        ms_ext = eob_ms | (c.TX_WIDTH[tx_size] << 8) \
            | (c.TX_HEIGHT[tx_size] << 20)
        self.os.txb(qcoeff, w, h, bhl, tx_class, skip_ctx, dc_sign_ctx,
                    cdfset, scan_off, ms_ext)
        return _cul_level_of(qcoeff)

    def finish(self):
        data = self.os.run()
        # mirror PySink: fc holds the tile-end adapted context (the
        # frame context stored with refs under primary_ref carry)
        self.arena.write_back(self.fc, self.os.final_arena)
        return data


def make_sequence_header(width: int, height: int,
                         enable_cdef: int = 0,
                         enable_restoration: int = 0,
                         bit_depth: int = 8,
                         screen: bool = False,
                         film_grain: bool = False,
                         subsampling: str = "420",
                         sb128: bool = False,
                         superres: bool = False,
                         filter_intra: bool = False,
                         order_hint: bool = False,
                         warped_motion: bool = False,
                         masked_compound: bool = False,
                         jnt_comp: bool = False,
                         interintra: bool = False,
                         intra_edge_filter: bool = False,
                         color_primaries: int = 2,
                         transfer_characteristics: int = 2,
                         matrix_coefficients: int = 2,
                         color_range: int = 0,
                         chroma_sample_position: int = 0
                         ) -> H.SequenceHeader:
    """Minimal-tools sequence config for the lossless all-intra path.
    10-bit 4:2:0 stays profile 0 (high_bitdepth=1); 4:4:4 needs
    profile 1 and 4:2:2 / 12-bit need profile 2 (spec 5.5.2
    color_config).  screen=True selects per-frame screen-content
    tools (palette)."""
    assert bit_depth in (8, 10, 12)
    assert subsampling in ("420", "422", "444")
    ss_x = 1 if subsampling in ("420", "422") else 0
    ss_y = 1 if subsampling == "420" else 0
    if subsampling == "422" or bit_depth == 12:
        profile = 2
    elif subsampling == "444":
        profile = 1
    else:
        profile = 0
    # color_config (spec 5.5.2; AV1E_SET_COLOR_PRIMARIES etc.): the
    # description triple is only signalled when any field is non-default
    color_present = (color_primaries, transfer_characteristics,
                     matrix_coefficients) != (2, 2, 2)
    return H.SequenceHeader(
        profile=profile, seq_level_idx=31,
        max_frame_width=width,
        max_frame_height=height, use_128x128_superblock=int(sb128),
        enable_filter_intra=int(filter_intra),
        enable_intra_edge_filter=int(intra_edge_filter),
        color_description_present=int(color_present),
        color_primaries=color_primaries,
        transfer_characteristics=transfer_characteristics,
        matrix_coefficients=matrix_coefficients,
        color_range=color_range,
        chroma_sample_position=chroma_sample_position,
        enable_order_hint=int(order_hint),
        enable_warped_motion=int(warped_motion),
        enable_masked_compound=int(masked_compound),
        enable_jnt_comp=int(jnt_comp and order_hint),
        enable_interintra_compound=int(interintra),
        enable_ref_frame_mvs=int(order_hint),
        order_hint_bits=7 if order_hint else 0,
        force_screen_content_tools=2 if screen else 0,
        force_integer_mv=2, enable_superres=int(superres),
        enable_cdef=enable_cdef,
        enable_restoration=enable_restoration,
        high_bitdepth=1 if bit_depth > 8 else 0,
        twelve_bit=int(bit_depth == 12),
        mono_chrome=0, film_grain_params_present=int(film_grain),
        subsampling_x=ss_x, subsampling_y=ss_y, separate_uv_delta_q=0)


def make_lossless_frame_header(sh: H.SequenceHeader,
                               tile_cols_log2: int = 0,
                               tile_rows_log2: int = 0) -> H.FrameHeader:
    return H.FrameHeader(
        frame_type=c.KEY_FRAME, show_frame=1, error_resilient_mode=1,
        disable_cdf_update=0, disable_frame_end_update_cdf=1,
        frame_size_override=0,
        frame_width=sh.max_frame_width, frame_height=sh.max_frame_height,
        render_width=sh.max_frame_width, render_height=sh.max_frame_height,
        base_q_idx=0, tx_mode=c.ONLY_4X4, reduced_tx_set=0,
        tile_cols_log2=tile_cols_log2, tile_rows_log2=tile_rows_log2)


class LosslessEncoder:
    """Encodes one key frame losslessly (DC-predicted 4x4 WHT blocks)."""

    PAD = 0  # extra right/bottom margin (lossy large-tx blocks may cross
    # the mi grid; the margin absorbs their out-of-frame recon writes)

    #: optional initial FrameContext (primary_ref CDF carry); when None,
    #: tiles start from the qindex-default context
    fc0 = None

    def __init__(self, sh: H.SequenceHeader, fh: H.FrameHeader,
                 use_native: bool | None = None):
        self.sh = sh
        self.fh = fh
        if use_native is None:
            from ..runtime import native_available
            use_native = native_available()
        self.use_native = use_native
        self.mi_cols = fh.mi_cols()
        self.mi_rows = fh.mi_rows()
        self.sb_mi = 1 << (sh.sb_size_log2 - 2)
        self.sb_size = c.BLOCK_128X128 if sh.use_128x128_superblock \
            else c.BLOCK_64X64
        self.ss_x, self.ss_y = sh.subsampling_x, sh.subsampling_y
        self.bd = sh.bit_depth
        self.num_planes = 1 if sh.mono_chrome else 3
        # per-4x4 luma mode grid, filled as blocks are coded
        self.mi_skip = np.zeros((self.mi_rows, self.mi_cols), dtype=np.uint8)
        self.mi_mode = np.full((self.mi_rows, self.mi_cols), c.DC_PRED,
                               dtype=np.int32)
        self.mi_bsize = np.full((self.mi_rows, self.mi_cols), c.BLOCK_64X64,
                                dtype=np.int32)
        self.mi_valid = np.zeros((self.mi_rows, self.mi_cols), dtype=bool)

    def pad_planes(self, planes) -> list:
        """Pad source planes to the mi grid (+PAD margin); fills src/recon."""
        w = self.mi_cols * 4
        h = self.mi_rows * 4
        self.src = []
        self.recon = []
        for i, p in enumerate(planes[:self.num_planes]):
            ph, pw = (h, w) if i == 0 else (h >> self.ss_y, w >> self.ss_x)
            buf = np.zeros((ph + self.PAD, pw + self.PAD),
                           dtype=np.uint8 if self.bd == 8 else np.uint16)
            sh_, sw_ = p.shape
            buf[:sh_, :sw_] = p
            # edge-replicate padding so padded-area residuals stay small
            if sw_ < pw:
                buf[:sh_, sw_:pw] = buf[:sh_, sw_ - 1:sw_]
            if sh_ < ph:
                buf[sh_:ph, :pw] = buf[sh_ - 1:sh_, :pw]
            self.src.append(buf)
            self.recon.append(np.zeros_like(buf))
        return self.src

    def encode_frame(self, planes, use_jax: bool = True,
                     analysis=None) -> bytes:
        """planes: (y, u, v) uint8 source.  Returns full temporal unit.

        analysis: optional precomputed device analyze (from
        ops/lossless.analyze_frames_for_encoder) for batched pipelines."""
        fh, sh = self.fh, self.sh
        self.pad_planes(planes)

        # batched analyze: per-4x4 qcoeff + zero flags for every plane
        # (device path; lossless ⇒ recon == source ⇒ fully parallel)
        if analysis is not None:
            self.analysis = analysis
        elif use_jax and (fh.tile_cols_log2 or fh.tile_rows_log2):
            from ..ops.lossless import analyze_tiled_for_encoder
            self.analysis = analyze_tiled_for_encoder(
                self.src, self.tile_px_ranges(rows=True),
                self.tile_px_ranges(rows=False))
        elif use_jax:
            from ..ops.lossless import analyze_for_encoder
            self.analysis = analyze_for_encoder(self.src)
        else:
            self.analysis = None

        from ..utils.profiler import profile
        with profile("encode/tile_walk"):
            tile_data = self._encode_tile()

        # in-loop filter search (picklpf/pickcdef/pickrst analog) MUST
        # run between tile encode and header serialization: it mutates
        # fh and filters recon, and the header must carry what recon got
        with profile("encode/filter_search"):
            tile_data = self._post_tile(tile_data)

        # assemble: TD + sequence header + frame OBU
        out = bytearray()
        out += H.temporal_delimiter()
        out += self.sequence_header_obu()
        out += self.frame_obu(tile_data)
        return bytes(out)

    def _post_tile(self, tile_data: bytes) -> bytes:
        """Hook between tile encode and header write; subclasses run
        filter searches here (may re-emit tile data, e.g. for LR
        units)."""
        return tile_data

    def sequence_header_obu(self) -> bytes:
        w_seq = BitWriter()
        H.write_sequence_header(self.sh, w_seq)
        w_seq.write_bit(1)  # trailing bit
        w_seq.byte_align()
        return H.wrap_obu(c.OBU_SEQUENCE_HEADER, w_seq.data())

    def frame_obu(self, tile_data: bytes) -> bytes:
        w_fh = BitWriter()
        H.write_frame_header(self.fh, self.sh, w_fh)
        w_fh.byte_align()
        return H.wrap_obu(c.OBU_FRAME, w_fh.data() + tile_data)

    def encode_frame_obu(self, planes, **kw) -> bytes:
        """Like encode_frame but returns ONLY the frame OBU (no TD / seq
        header) — for multi-frame temporal units (hidden ARFs)."""
        full = self.encode_frame(planes, **kw)
        return b"".join(H.wrap_obu(t, p) for (t, p) in H.split_obus(full)
                        if t == c.OBU_FRAME)

    # --- tile encode ------------------------------------------------------

    def tile_mi_range(self, idx: int, rows: bool):
        """Uniform tile spacing (spec 5.9.15): mi [start, end) of tile
        row/col idx.  Mirrors decoder.tile_row_range/tile_col_range."""
        fh, sh = self.fh, self.sh
        log2 = fh.tile_rows_log2 if rows else fh.tile_cols_log2
        sbs = fh.sb_rows(sh) if rows else fh.sb_cols(sh)
        mi_max = self.mi_rows if rows else self.mi_cols
        size_sb = (sbs + (1 << log2) - 1) >> log2
        start = min(idx * size_sb, sbs)
        end = min((idx + 1) * size_sb, sbs)
        return start * self.sb_mi, min(end * self.sb_mi, mi_max)

    def tile_px_ranges(self, rows: bool):
        log2 = self.fh.tile_rows_log2 if rows else self.fh.tile_cols_log2
        out = []
        for i in range(1 << log2):
            s, e = self.tile_mi_range(i, rows)
            if s < e:
                out.append((s * 4, e * 4))
        return out

    def _encode_tile(self) -> bytes:
        if (self.use_native and self.analysis is not None
                and type(self) is LosslessEncoder):
            # full-native walk: partition + modes + coeffs in C
            # (runtime/lossless_tile.c), byte-exact with the path below
            from ..runtime import encode_lossless_tile
            fh = self.fh
            for plane in range(self.num_planes):
                self.recon[plane][:] = self.src[plane]
            tiles = []
            for (r0, r1) in [self.tile_mi_range(i, True)
                             for i in range(1 << fh.tile_rows_log2)]:
                for (c0, c1) in [self.tile_mi_range(i, False)
                                 for i in range(1 << fh.tile_cols_log2)]:
                    self.fc = FrameContext(fh.base_q_idx)
                    tiles.append(encode_lossless_tile(
                        self.fc, self.analysis, r1 - r0, c1 - c0,
                        self.num_planes, sb_mi=self.sb_mi,
                        mi_row0=r0, mi_col0=c0))
            return pack_tile_group(tiles, fh.tile_size_bytes)
        assert not (self.fh.tile_cols_log2 or self.fh.tile_rows_log2), \
            "multi-tile requires the native walker path"
        self.fc = (self.fc0.copy() if getattr(self, "fc0", None) is not None
                   else FrameContext(self.fh.base_q_idx))
        if self.use_native:
            self.sink = NativeSink(self.fc)
        else:
            self.sink = PySink(self.fc)
        self.above_partition = np.zeros(self.mi_cols + 32, dtype=np.uint8)
        self.left_partition = np.zeros(self.mi_rows + 32, dtype=np.uint8)
        # +32 margin: edge-crossing transform blocks read/write ctx beyond
        # the mi grid (the reference pads these arrays to SB multiples)
        self.above_entropy = [np.zeros(self.mi_cols + 32, dtype=np.uint8)
                              for _ in range(self.num_planes)]
        self.left_entropy = [np.zeros(self.mi_rows + 32, dtype=np.uint8)
                             for _ in range(self.num_planes)]
        # tx-size context spans (only read under TX_MODE_SELECT)
        self.above_txfm = np.full(self.mi_cols + 32, 64, dtype=np.uint8)
        self.left_txfm = np.full(self.mi_rows + 32, 64, dtype=np.uint8)
        for mi_row in range(0, self.mi_rows, self.sb_mi):
            self.left_partition[:] = 0
            for le in self.left_entropy:
                le[:] = 0
            self.left_txfm[:] = 64
            for mi_col in range(0, self.mi_cols, self.sb_mi):
                self._encode_partition(mi_row, mi_col, self.sb_size)
        return self.sink.finish()

    def _choose_partition(self, mi_row, mi_col, bsize) -> int:
        """Fixed strategy: NONE for fully-visible blocks, else split toward
        the frame edge (HORZ/VERT when only one direction fits)."""
        bw = blockd.mi_size_wide(bsize)
        hbs = bw // 2
        if bsize < c.BLOCK_8X8:
            return c.PARTITION_NONE
        fits_rows = mi_row + bw <= self.mi_rows
        fits_cols = mi_col + bw <= self.mi_cols
        if fits_rows and fits_cols:
            return c.PARTITION_NONE
        has_rows = mi_row + hbs < self.mi_rows
        has_cols = mi_col + hbs < self.mi_cols
        if not has_rows and fits_cols:
            return c.PARTITION_HORZ
        if not has_cols and fits_rows:
            return c.PARTITION_VERT
        return c.PARTITION_SPLIT

    def _partition_ctx(self, mi_row, mi_col, bsize):
        bsl = (blockd.mi_size_wide(bsize).bit_length() - 1) - 1
        above = (int(self.above_partition[mi_col]) >> bsl) & 1
        left = (int(self.left_partition[mi_row]) >> bsl) & 1
        return (left * 2 + above) + bsl * PARTITION_PLOFFSET

    def _write_partition(self, mi_row, mi_col, bsize, partition):
        hbs = blockd.mi_size_wide(bsize) // 2
        has_rows = mi_row + hbs < self.mi_rows
        has_cols = mi_col + hbs < self.mi_cols
        if not has_rows and not has_cols:
            assert partition == c.PARTITION_SPLIT
            return
        ctx = self._partition_ctx(mi_row, mi_col, bsize)
        from ..decoder.decoder import FrameDecoder
        if has_rows and has_cols:
            n = FrameDecoder._partition_cdf_length(bsize)
            self.sink.symbol(partition, n, "partition_cdf", ctx)
        else:
            # gathered binary: symbol 1 == SPLIT
            sym = int(partition == c.PARTITION_SPLIT)
            assert partition in (c.PARTITION_SPLIT,
                                 c.PARTITION_HORZ if not has_rows
                                 else c.PARTITION_VERT)
            self.sink.gather_split(sym, ctx, bsize == c.BLOCK_128X128,
                                   horz_alike=not has_cols)

    def _encode_partition(self, mi_row, mi_col, bsize):
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        bw = blockd.mi_size_wide(bsize)
        hbs = bw // 2
        partition = self._choose_partition(mi_row, mi_col, bsize)
        if bsize >= c.BLOCK_8X8:
            self._write_partition(mi_row, mi_col, bsize, partition)
        subsize = blockd.partition_subsize(bsize, partition)
        P = c
        if partition == P.PARTITION_NONE:
            self._encode_block(mi_row, mi_col, subsize, partition)
        elif partition == P.PARTITION_HORZ:
            self._encode_block(mi_row, mi_col, subsize, partition)
            if mi_row + hbs < self.mi_rows:
                self._encode_block(mi_row + hbs, mi_col, subsize, partition)
        elif partition == P.PARTITION_VERT:
            self._encode_block(mi_row, mi_col, subsize, partition)
            if mi_col + hbs < self.mi_cols:
                self._encode_block(mi_row, mi_col + hbs, subsize, partition)
        elif partition == P.PARTITION_SPLIT:
            self._encode_partition(mi_row, mi_col, subsize)
            self._encode_partition(mi_row, mi_col + hbs, subsize)
            self._encode_partition(mi_row + hbs, mi_col, subsize)
            self._encode_partition(mi_row + hbs, mi_col + hbs, subsize)
        else:
            raise AssertionError(partition)
        self._update_ext_partition_ctx(mi_row, mi_col, subsize, bsize,
                                       partition)

    def _update_partition_ctx(self, mi_row, mi_col, subsize, bsize):
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        bw4 = blockd.mi_size_wide(subsize)
        bh4 = blockd.mi_size_high(subsize)
        above = (31 << (bw4.bit_length() - 1)) & 31
        left = (31 << (bh4.bit_length() - 1)) & 31
        self.above_partition[mi_col:mi_col + bw] = above
        self.left_partition[mi_row:mi_row + bh] = left

    def _update_ext_partition_ctx(self, mi_row, mi_col, subsize, bsize,
                                  partition):
        """update_ext_partition_context mirror (decoder.py:795): AB
        shapes update the two halves with their own effective sizes."""
        if bsize < c.BLOCK_8X8:
            return
        if partition == c.PARTITION_SPLIT and bsize != c.BLOCK_8X8:
            return
        hbs = blockd.mi_size_wide(bsize) // 2
        bsize2 = blockd.partition_subsize(bsize, c.PARTITION_SPLIT)
        if partition == c.PARTITION_HORZ_A:
            self._update_partition_ctx(mi_row, mi_col, bsize2, subsize)
            self._update_partition_ctx(mi_row + hbs, mi_col, subsize,
                                       subsize)
        elif partition == c.PARTITION_HORZ_B:
            self._update_partition_ctx(mi_row, mi_col, subsize, subsize)
            self._update_partition_ctx(mi_row + hbs, mi_col, bsize2,
                                       subsize)
        elif partition == c.PARTITION_VERT_A:
            self._update_partition_ctx(mi_row, mi_col, bsize2, subsize)
            self._update_partition_ctx(mi_row, mi_col + hbs, subsize,
                                       subsize)
        elif partition == c.PARTITION_VERT_B:
            self._update_partition_ctx(mi_row, mi_col, subsize, subsize)
            self._update_partition_ctx(mi_row, mi_col + hbs, bsize2,
                                       subsize)
        else:
            self._update_partition_ctx(mi_row, mi_col, subsize, bsize)

    # --- block encode -----------------------------------------------------

    def _encode_block(self, mi_row, mi_col, bsize, partition):
        fc = self.fc
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        up_avail = mi_row > 0
        left_avail = mi_col > 0

        # --- compute the whole block's residual decisions first (skip flag
        # must be written before mode/coeffs, and depends on all txbs) ---
        # For lossless DC-only: skip iff every residual is zero, i.e. the
        # prediction already equals the source everywhere.  We must commit
        # to skip BEFORE knowing recon (prediction depends on recon of
        # neighbors, already final).  Compute per-txb data in coding order.
        plan = self._plan_block(mi_row, mi_col, bsize, up_avail, left_avail)
        skip = all(not np.any(q) for (_, _, _, _, q, _) in plan)

        # skip_txfm symbol
        above_mi = (mi_row - 1, mi_col) if up_avail else None
        left_mi = (mi_row, mi_col - 1) if left_avail else None
        skip_ctx = (int(self.mi_skip[above_mi]) if above_mi else 0) + \
                   (int(self.mi_skip[left_mi]) if left_mi else 0)
        self.sink.symbol(int(skip), 2, "skip_txfm_cdfs", skip_ctx)

        # y mode (DC) via kf cdf
        above_mode = int(self.mi_mode[above_mi]) if above_mi else c.DC_PRED
        left_mode = int(self.mi_mode[left_mi]) if left_mi else c.DC_PRED
        self.sink.symbol(c.DC_PRED, c.INTRA_MODES, "kf_y_cdf",
                         INTRA_MODE_CONTEXT[above_mode],
                         INTRA_MODE_CONTEXT[left_mode])
        # DC: no angle delta
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        if is_chroma_ref:
            cfl_allowed = blockd.plane_block_size(
                bsize, self.ss_x, self.ss_y) == c.BLOCK_4X4
            self.sink.symbol(
                c.DC_PRED, c.UV_INTRA_MODES - int(not cfl_allowed),
                "uv_mode_cdf", int(cfl_allowed), c.DC_PRED)
        # filter intra: seq-disabled; palette: screen content off

        rmax = min(mi_row + bh, self.mi_rows)
        cmax = min(mi_col + bw, self.mi_cols)
        self.mi_skip[mi_row:rmax, mi_col:cmax] = int(skip)
        self.mi_mode[mi_row:rmax, mi_col:cmax] = c.DC_PRED
        self.mi_valid[mi_row:rmax, mi_col:cmax] = True

        # coeffs + recon
        for (plane, py, px, plane_bsize, qcoeff, pred) in plan:
            txw, txh = 1, 1
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            # entropy ctx coords in plane mi units (plane px / 4)
            acol = px >> 2
            lrow = py >> 2
            au = self.above_entropy[plane]
            lu = self.left_entropy[plane]
            if skip:
                au[acol:acol + txw] = 0
                lu[lrow:lrow + txh] = 0
            else:
                skip_ctx2, dc_sign_ctx = CF.txb_ctx(
                    plane_bsize, c.TX_4X4, plane, au[acol:acol + txw],
                    lu[lrow:lrow + txh])
                cul = self.sink.txb(qcoeff, plane, skip_ctx2, dc_sign_ctx)
                au[acol:acol + txw] = cul
                lu[lrow:lrow + txh] = cul
            # lossless: recon == source in both branches (skip ⇒ pred==src)
            self.recon[plane][py:py + 4, px:px + 4] = \
                self.src[plane][py:py + 4, px:px + 4]

    def _plan_block(self, mi_row, mi_col, bsize, up_avail, left_avail):
        """Predict + transform every 4x4 txb of the block in coding order.

        DC prediction depends only on previously-reconstructed pixels
        (outside this block or earlier txbs of it, which for lossless equal
        the source when not skipped).  To decide the block-level skip flag
        up front we predict against a recon image where this block's own
        area is temporarily filled with source (valid iff skip-decision
        outcome keeps residuals zero; if any residual is nonzero we encode
        coefficients and recon==source anyway, so predictions stay
        consistent either way -- UNLESS a zero-residual txb follows a
        nonzero one inside the same skipped block.  Since skip is only
        chosen when ALL residuals are zero, recon==source holds in both
        branches and the temporary fill is exact.)
        """
        plan = []
        chroma_up = up_avail
        chroma_left = left_avail
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        if self.ss_x and bw < 2:
            chroma_left = (mi_col - 1) > 0
        if self.ss_y and bh < 2:
            chroma_up = (mi_row - 1) > 0
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        nplanes = self.num_planes if is_chroma_ref else 1
        for plane in range(nplanes):
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            plane_bsize = blockd.plane_block_size(bsize, ss_x, ss_y) \
                if plane else bsize
            pbw = blockd.block_wide(plane_bsize)
            pbh = blockd.block_high(plane_bsize)
            row0 = ((mi_row - (mi_row & ss_y)) * 4) >> ss_y if plane \
                else mi_row * 4
            col0 = ((mi_col - (mi_col & ss_x)) * 4) >> ss_x if plane \
                else mi_col * 4
            mb_to_right = (self.mi_cols - bw - mi_col) * 4
            mb_to_bottom = (self.mi_rows - bh - mi_row) * 4
            vis_w = pbw + (min(mb_to_right, 0) >> ss_x)
            vis_h = pbh + (min(mb_to_bottom, 0) >> ss_y)
            src = self.src[plane]
            rec = self.recon[plane]
            for r4 in range(0, max(vis_h >> 2, 1)):
                for c4 in range(0, max(vis_w >> 2, 1)):
                    y = r4 * 4
                    x = c4 * 4
                    py, px = row0 + y, col0 + x
                    if self.analysis is not None:
                        q, _ = self.analysis[plane]
                        plan.append((plane, py, px, plane_bsize,
                                     q[py >> 2, px >> 2], None))
                        continue
                    have_top = r4 > 0 or (chroma_up if ss_y else up_avail)
                    have_left = c4 > 0 or (chroma_left if ss_x
                                           else left_avail)
                    xr = (mb_to_right >> ss_x) + pbw - x - 4
                    yd = (mb_to_bottom >> ss_y) + pbh - y - 4
                    # within-block txbs predict from source-filled recon
                    ref = rec.copy()
                    # temporarily treat already-planned area + own block
                    # interior as source (lossless recon == source)
                    ref[row0:row0 + pbh, col0:col0 + pbw] = \
                        src[row0:row0 + pbh, col0:col0 + pbw]
                    pred = intra.build_intra_predictor(
                        ref, px, py, 4, 4, c.DC_PRED, 0, -1,
                        n_top_px=min(4, xr + 4) if have_top else 0,
                        n_topright_px=-1,
                        n_left_px=min(4, yd + 4) if have_left else 0,
                        n_bottomleft_px=-1,
                        disable_edge_filter=True, intra_edge_filter_type=0,
                        bd=self.bd)
                    resid = src[py:py + 4, px:px + 4].astype(np.int32) \
                        - pred.astype(np.int32)
                    coeff = fwht4x4(resid)
                    q = coeff // 4  # exact: WHT output is a multiple of 4
                    plan.append((plane, py, px, plane_bsize,
                                 q.ravel(), pred))
        return plan


def encode_lossless_ivf(path: str, frames, width: int, height: int,
                        fps=(30, 1)) -> None:
    """Encode frames (list of (y,u,v)) as all-keyframe lossless IVF.

    The per-4x4 analyze for ALL frames runs as one batched jit call (one
    device round-trip); the per-frame native tile walk then packs each
    frame's symbols at C speed."""
    sh = make_sequence_header(width, height)
    encs = []
    srcs = []
    for f in frames:
        fh = make_lossless_frame_header(sh)
        enc = LosslessEncoder(sh, fh)
        srcs.append(enc.pad_planes(f))
        encs.append(enc)
    from ..ops.lossless import analyze_frames_for_encoder
    analyses = analyze_frames_for_encoder(srcs)
    payloads = []
    for i, (enc, f, an) in enumerate(zip(encs, frames, analyses)):
        payloads.append((enc.encode_frame(f, analysis=an), i))
    write_ivf(path, payloads, width, height, fps[0], fps[1])
