"""Multi-chip sharding for the encoder (jax.sharding over a device Mesh).

Device mapping of the reference's parallelism (SURVEY §2.7):
  * tile-parallel  → 'tile' mesh axis: AV1 tile columns are fully
    independent (prediction availability and entropy state reset at tile
    edges), so the per-tile analyze shards with NO halo communication —
    the only cross-chip traffic is the final qcoeff gather + the rate
    reduction (psum).  Reference analog: av1_encode_tiles_mt
    (av1/encoder/ethread.c:1506), one worker per tile.
  * frame-parallel (FPMT, ethread.c:1224) → 'frame' mesh axis: a batch
    of frames encodes concurrently.

The sharded path drives the REAL lossless encoder: device analyze per
(frame, tile) shard, then per-tile native entropy walk + tile-group
packing on host, producing streams byte-identical to the single-device
encoder (tested in tests/test_sharding.py — the ethread_test.cc
determinism contract).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.lossless import lossless_plane_analyze


def make_mesh(n_frame: int, n_tile: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_frame * n_tile
    arr = np.array(devices[:n_frame * n_tile]).reshape(n_frame, n_tile)
    return Mesh(arr, ("frame", "tile"))


def _tiled_analyze(ys, us, vs):
    """(F, T, H, Wt) stacked tile columns -> per-plane int16 qcoeffs +
    a frame-level rate proxy (psum across the mesh)."""
    an2 = jax.vmap(jax.vmap(lossless_plane_analyze))
    qy, _ = an2(ys)
    qu, _ = an2(us)
    qv, _ = an2(vs)
    bits_proxy = (jnp.abs(qy).sum(dtype=jnp.float32)
                  + jnp.abs(qu).sum(dtype=jnp.float32)
                  + jnp.abs(qv).sum(dtype=jnp.float32))
    return (qy.astype(jnp.int16), qu.astype(jnp.int16),
            qv.astype(jnp.int16), bits_proxy)


def make_sharded_tile_analyze(mesh: Mesh):
    """jit of the tiled analyze with (frame, tile) input sharding; XLA
    inserts the psum for the rate proxy."""
    shard_in = NamedSharding(mesh, P("frame", "tile", None, None))
    shard_q = NamedSharding(mesh, P("frame", "tile", None, None, None))
    return jax.jit(
        _tiled_analyze,
        in_shardings=(shard_in, shard_in, shard_in),
        out_shardings=(shard_q, shard_q, shard_q,
                       NamedSharding(mesh, P())))


class ShardedLosslessEncoder:
    """Lossless all-intra encoder sharded over a ('frame','tile') mesh.

    Requires width to split into equal SB-aligned tile columns (the
    general unequal-tile path lives in encoder/encoder.py).  Produces
    the same bytes as the single-device encoder.
    """

    def __init__(self, width: int, height: int, mesh: Mesh):
        from ..encoder.encoder import (make_lossless_frame_header,
                                       make_sequence_header)
        self.mesh = mesh
        self.n_tile = mesh.devices.shape[1]
        self.n_frame = mesh.devices.shape[0]
        tile_cols_log2 = max(self.n_tile - 1, 0).bit_length()
        assert (1 << tile_cols_log2) == self.n_tile, \
            "tile count must be a power of two"
        self.sh = make_sequence_header(width, height)
        self.fh = make_lossless_frame_header(
            self.sh, tile_cols_log2=tile_cols_log2)
        self.mi_cols = self.fh.mi_cols()
        self.mi_rows = self.fh.mi_rows()
        sb_cols = self.fh.sb_cols(self.sh)
        assert sb_cols % self.n_tile == 0 and width % 64 == 0 \
            and height % 8 == 0 and width % (self.n_tile * 4) == 0, \
            "sharded path needs equal SB-aligned tile columns"
        self._fn = make_sharded_tile_analyze(mesh)

    def _split_tiles(self, plane, ss):
        H, W = plane.shape
        T = self.n_tile
        wt = W // T
        return plane.reshape(H, T, wt).transpose(1, 0, 2)

    def encode_frames(self, frames) -> list:
        """frames: list of (y, u, v); length must be a multiple of the
        mesh frame axis.  Returns one temporal-unit payload per frame."""
        from ..bitstream.tables import FrameContext
        from ..encoder.encoder import LosslessEncoder, pack_tile_group
        from ..runtime import encode_lossless_tile
        F = len(frames)
        assert F % self.n_frame == 0, \
            f"frame count {F} not a multiple of mesh axis {self.n_frame}"
        ys = np.stack([self._split_tiles(f[0], 0) for f in frames])
        us = np.stack([self._split_tiles(f[1], 1) for f in frames])
        vs = np.stack([self._split_tiles(f[2], 1) for f in frames])
        payloads = []
        with self.mesh:
            for f0 in range(0, F, self.n_frame):
                sl = slice(f0, f0 + self.n_frame)
                qy, qu, qv, _bits = self._fn(
                    jnp.asarray(ys[sl]), jnp.asarray(us[sl]),
                    jnp.asarray(vs[sl]))
                qy, qu, qv = np.asarray(qy), np.asarray(qu), np.asarray(qv)
                for fi in range(self.n_frame):
                    payloads.append(self._pack_frame(
                        frames[f0 + fi], qy[fi], qu[fi], qv[fi]))
        return payloads

    def _pack_frame(self, planes, qy_t, qu_t, qv_t) -> bytes:
        """Assemble one frame's TU from per-tile qcoeffs (T, h4, wt4, 16).

        Reuses the single-device encoder for headers; the per-tile
        entropy walk runs the same native coder."""
        from ..bitstream import headers as Hd
        from ..bitstream.tables import FrameContext
        from ..encoder.encoder import LosslessEncoder, pack_tile_group
        from ..runtime import encode_lossless_tile
        enc = LosslessEncoder(self.sh, self.fh)
        enc.pad_planes(planes)
        tiles = []
        for t in range(self.n_tile):
            # tile-local analysis arrays: walker reads offset (0, 0)
            analysis = [(qy_t[t], None), (qu_t[t], None), (qv_t[t], None)]
            r0, r1 = 0, self.mi_rows
            c0, c1 = enc.tile_mi_range(t, rows=False)
            fc = FrameContext(self.fh.base_q_idx)
            tiles.append(encode_lossless_tile(
                fc, analysis, r1 - r0, c1 - c0, enc.num_planes,
                sb_mi=enc.sb_mi))
        tile_data = pack_tile_group(tiles, self.fh.tile_size_bytes)
        out = bytearray()
        out += Hd.temporal_delimiter()
        out += enc.sequence_header_obu()
        out += enc.frame_obu(tile_data)
        return bytes(out)


# --- legacy toy analyze kept for the simple sharding demo/tests --------


def batched_analyze_step(y_batch):
    """Analyze a batch of luma planes: (B, H, W) uint8 -> qcoeff + a global
    bit-cost proxy (psum-style reduction across the mesh)."""
    q, zero = jax.vmap(lossless_plane_analyze)(y_batch)
    # rate proxy: total nonzero coefficient magnitude (drives RC later);
    # float32: int32 can overflow here
    bits_proxy = jnp.sum(jnp.abs(q).astype(jnp.float32))
    return q, zero, bits_proxy


def make_sharded_analyze(mesh: Mesh):
    """jit the batched analyze with frame-batch and tile (width) sharding.

    Width sharding corresponds to AV1 tile columns: each 'tile' device
    analyzes its columns independently; XLA inserts the cross-device
    reduction for the rate proxy.
    """
    in_shard = NamedSharding(mesh, P("frame", None, "tile"))
    out_shard = (NamedSharding(mesh, P("frame", None, "tile", None)),
                 NamedSharding(mesh, P("frame", None, "tile")),
                 NamedSharding(mesh, P()))
    return jax.jit(batched_analyze_step, in_shardings=(in_shard,),
                   out_shardings=out_shard)

# ---------------------------------------------------------------------------
# FPMT analog: frame-parallel P-frame encode over the 'frame' mesh axis
# ---------------------------------------------------------------------------

_FPMT_FN_CACHE = {}


def make_sharded_p_frame_fn(mesh: Mesh, H: int, W: int, n_refs: int = 1):
    """Batched whole-frame P-frame analysis (motion search + MC +
    transforms, ops/inter_tpu.py) vmapped over a frame batch and sharded
    on the mesh 'frame' axis; references are replicated.  XLA partitions
    the batch across devices with zero cross-chip traffic (frames are
    independent given their shared references — the FPMT condition,
    av1/encoder/ethread.c:1224)."""
    key = (id(mesh), H, W, n_refs)
    fn = _FPMT_FN_CACHE.get(key)
    if fn is not None:
        return fn
    from ..ops.inter_tpu import _p_frame_core
    core = _p_frame_core((H, W, n_refs, True, False))
    batched = jax.vmap(core, in_axes=(0, 0, 0) + (None,) * 9)
    sb = NamedSharding(mesh, P("frame"))
    rep = NamedSharding(mesh, P())
    fn = jax.jit(batched,
                 in_shardings=(sb, sb, sb) + (rep,) * 9,
                 out_shardings=sb)
    _FPMT_FN_CACHE[key] = fn
    return fn


def _fpmt_group_fn(mesh, H, W, sharpness: int = 0):
    """jitted FPMT group program: P frames vmapped over the 'frame'
    mesh axis with per-frame quantizers, fixed (anchor, ARF) refs."""
    key = ("grp", id(mesh), H, W, sharpness)
    fn = _FPMT_FN_CACHE.get(key)
    if fn is not None:
        return fn
    from ..ops.inter_tpu import _p_frame_core, _pad_ref_jnp
    from ..ops.deblock_jnp import deblock_leafmask
    core = _p_frame_core((H, W, 2, True, True))
    nby, nbx = H // 16, W // 16

    def leaf_ids(lvl16):
        bi = jnp.arange(nby * nbx, dtype=jnp.int32).reshape(nby, nbx)
        rr = jnp.arange(nby)[:, None]
        cc_ = jnp.arange(nbx)[None, :]
        id32 = ((rr & ~1) * nbx + (cc_ & ~1)).astype(jnp.int32)
        id64 = ((rr & ~3) * nbx + (cc_ & ~3)).astype(jnp.int32)
        return jnp.where(lvl16 == 2, id64,
                         jnp.where(lvl16 == 1, id32, bi))

    def one(sy, su, sv, pq, lf, lam, hp, refs):
        ry, ru, rv, ry2 = refs
        (hdr, ctr, cfull, rec, lvl16, h32, c32, cfull32, h64, c64,
         cfull64, fsel) = core(sy, su, sv, ry, ru, rv, ry2,
                               pq[0], pq[1], pq[2], lam, hp=hp)
        # in-loop deblock per frame (FPMT frames are not chained, but
        # the output recon must match the decoder's filtered frame)
        rec_y, rec_u, rec_v = deblock_leafmask(
            rec[:H], rec[H:, :W // 2], rec[H:, W // 2:],
            lf[0], lf[1], lf[2], leaf_ids(lvl16), sharpness=sharpness)
        rec = jnp.concatenate([
            rec_y, jnp.concatenate([rec_u, rec_v], axis=1)], axis=0)
        return (hdr, ctr, cfull, rec, lvl16, h32, c32, cfull32, h64,
                c64, cfull64, fsel)

    def group(srcs_y, srcs_u, srcs_v, pq_stack, lf_stack, lam_stack,
              hp_stack, ly, lu, lv, ay, au, av):
        lpy, lpu, lpv, ly2 = _pad_ref_jnp(ly, lu, lv)
        apy, apu, apv, ay2 = _pad_ref_jnp(ay, au, av)
        refs = (jnp.stack([lpy, apy]), jnp.stack([lpu, apu]),
                jnp.stack([lpv, apv]), jnp.stack([ly2, ay2]))
        return jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, 0, None))(
            srcs_y, srcs_u, srcs_v, pq_stack, lf_stack, lam_stack,
            hp_stack, refs)

    if mesh is None:
        fn = jax.jit(group)
    else:
        sb = NamedSharding(mesh, P("frame"))
        rep = NamedSharding(mesh, P())
        fn = jax.jit(group,
                     in_shardings=(sb, sb, sb, sb, sb, sb, sb)
                     + (rep,) * 6,
                     out_shardings=sb)
    _FPMT_FN_CACHE[key] = fn
    return fn


def fpmt_encode_group(mesh, src_frames, qindexes, last_planes,
                      arf_planes, lf_levels=None, sharpness: int = 0):
    """FPMT analog for the REAL GopEncoder (av1_compress_parallel_frames,
    av1/encoder/ethread.c:1224): every P frame of the group references
    only the fixed (anchor, ARF) pair, so the device analyses shard over
    the 'frame' mesh axis with replicated references and no cross-chip
    traffic.  mesh=None runs the identical program on one device (the
    fpmt_unit_test_cfg-style determinism cross-check, encoder.h:2607).

    Returns (raws, recons) like DeviceChainEncoder.encode_chain
    (recons fetched for every frame — they are not chained)."""
    from ..common import quant as Q
    from ..ops.inter_tpu import (_pq_array, assemble_group_merge,
                                 rd_lambda, split_recon)
    from ..utils.xfer import fetch
    L = len(src_frames)
    H, W = src_frames[0][0].shape[:2]
    assert H % 16 == 0 and W % 16 == 0
    fn = _fpmt_group_fn(mesh, H, W, sharpness)
    pq_stack = np.stack([
        np.stack([_pq_array(Q.build_plane_quant(q, 0, 0))] * 3)
        for q in qindexes])
    if lf_levels is None:
        lf_stack = np.zeros((L, 3), np.int32)
    else:
        lf_stack = np.asarray(
            [lv if isinstance(lv, (tuple, list)) else (lv,) * 3
             for lv in lf_levels], np.int32)
    lam_stack = np.asarray([rd_lambda(q) for q in qindexes], np.float32)
    hp_stack = np.asarray([1 if q < 128 else 0 for q in qindexes],
                          np.int32)
    stk = (jnp.stack if not isinstance(src_frames[0][0], np.ndarray)
           else np.stack)
    srcs_y = stk([f[0][:H, :W] for f in src_frames])
    srcs_u = stk([f[1][:H >> 1, :W >> 1] for f in src_frames])
    srcs_v = stk([f[2][:H >> 1, :W >> 1] for f in src_frames])
    lp, ap = last_planes, arf_planes
    (hdr_d, ctr_d, cfull_d, rec_d, lvl_d, h32_d, c32_d, cfull32_d,
     h64_d, c64_d, cfull64_d, fsel_d) = fn(
        srcs_y, srcs_u, srcs_v, pq_stack, lf_stack, lam_stack, hp_stack,
        lp[0][:H, :W], lp[1][:H >> 1, :W >> 1],
        lp[2][:H >> 1, :W >> 1],
        ap[0][:H, :W], ap[1][:H >> 1, :W >> 1],
        ap[2][:H >> 1, :W >> 1])
    hdr, ctr, lvl, h32, c32, h64, c64, fsel, rec = fetch(
        hdr_d, ctr_d, lvl_d, h32_d, c32_d, h64_d, c64_d, fsel_d, rec_d)
    raws = assemble_group_merge(hdr, ctr, cfull_d, lvl, h32, c32,
                                cfull32_d, h64, c64, cfull64_d)
    for j in range(L):
        raws[j]["filt"] = int(fsel[j])
    recons = [split_recon(rec[j], H, W) for j in range(L)]
    return raws, recons


class ShardedInterGopEncoder:
    """Flat-GOP frame-parallel encoder: one intra anchor + a batch of
    P-frames that all reference ONLY the anchor, so the per-frame device
    analysis runs concurrently across the 'frame' mesh axis.  The host
    entropy emit stays serial per frame (byte-stream order), producing
    streams byte-identical to the serial flat-ref encode
    (tests/test_sharding.py contract)."""

    def __init__(self, width: int, height: int, mesh: Mesh,
                 qindex: int = 60, use_native=None):
        assert width % 16 == 0 and height % 16 == 0
        from ..encoder.encoder import make_sequence_header
        self.mesh = mesh
        self.n_frame = int(np.prod(mesh.devices.shape))
        self.width, self.height = width, height
        self.qindex = qindex
        self.use_native = use_native
        self.sh = make_sequence_header(width, height, enable_cdef=0)

    def _encode_anchor(self, planes):
        from ..encoder.lossy import make_lossy_frame_header
        from ..encoder.tpu_intra import TpuAllIntraEncoder
        fh = make_lossy_frame_header(self.sh, self.qindex)
        enc = TpuAllIntraEncoder(self.sh, fh, use_native=self.use_native)
        payload = enc.encode_frame(planes)
        w, h = self.width, self.height
        rec = (enc.recon[0][:h, :w].copy(),
               enc.recon[1][:h // 2, :w // 2].copy(),
               enc.recon[2][:h // 2, :w // 2].copy())
        return payload, rec

    def encode_frames(self, frames):
        """frames[0] = anchor (intra), frames[1:] = P batch.  Returns
        one packed TU payload per frame."""
        import jax.numpy as jnp
        from ..bitstream import headers as HH
        from ..encoder.tpu_inter import (TpuInterFrameEncoder,
                                         make_inter_frame_header)
        from ..ops.inter_tpu import PADR, _pq_array
        from ..common import quant as Q
        anchor_payload, anchor_rec = self._encode_anchor(frames[0])
        pfrs = frames[1:]
        if not pfrs:
            return [anchor_payload]
        H, W = self.height, self.width
        fn = make_sharded_p_frame_fn(self.mesh, H, W, 1)
        ys = jnp.asarray(np.stack([f[0][:H, :W] for f in pfrs]))
        us = jnp.asarray(np.stack([f[1][:H >> 1, :W >> 1] for f in pfrs]))
        vs = jnp.asarray(np.stack([f[2][:H >> 1, :W >> 1] for f in pfrs]))
        ref_y = np.pad(anchor_rec[0], PADR, mode="edge").astype(np.uint8)
        ref_u = np.pad(anchor_rec[1], PADR, mode="edge")
        ref_v = np.pad(anchor_rec[2], PADR, mode="edge")
        y2 = ref_y.astype(np.int32)
        h2, w2 = (y2.shape[0] // 2) * 2, (y2.shape[1] // 2) * 2
        y2 = y2[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).sum((1, 3))
        pq = [_pq_array(Q.build_plane_quant(self.qindex, 0, 0))
              for _ in range(3)]
        from ..ops.inter_tpu import rd_lambda
        (hdr_d, ctr_d, cfull_d, rec_d, lvl_d, h32_d, c32_d, cfull32_d,
         h64_d, c64_d, cfull64_d, _fsel_d) = fn(
            ys, us, vs,
            jnp.asarray(ref_y[None]), jnp.asarray(ref_u[None]),
            jnp.asarray(ref_v[None]), jnp.asarray(y2[None]),
            pq[0], pq[1], pq[2], rd_lambda(self.qindex),
            np.int32(1 if self.qindex < 128 else 0))
        from ..utils.xfer import fetch
        from ..ops.inter_tpu import assemble_group_merge, split_recon
        hdr, ctr, lvl, h32, c32, h64, c64, rec = fetch(
            hdr_d, ctr_d, lvl_d, h32_d, c32_d, h64_d, c64_d, rec_d)
        raws = assemble_group_merge(hdr, ctr, cfull_d, lvl, h32, c32,
                                    cfull32_d, h64, c64, cfull64_d)
        payloads = [anchor_payload]
        slots = [anchor_rec] + [None] * 7
        for i in range(len(pfrs)):
            fh = make_inter_frame_header(self.sh, self.qindex,
                                         refresh_frame_flags=0)
            enc = TpuInterFrameEncoder(self.sh, fh, slots,
                                       use_native=self.use_native)
            enc._results = None
            enc._external_results = True
            enc._external_recon = split_recon(rec[i], H, W)
            enc._res_raw = raws[i]
            obu = enc.encode_frame_obu(pfrs[i])
            payloads.append(HH.temporal_delimiter() + obu)
        return payloads
