"""GOP structure + rate-controlled encoding: KEY / ARF / P frames.

Re-design of libaom's encode strategy (reference behavior:
av1/encoder/encode_strategy.c av1_encode_strategy :1213 — frame-type
decision, ref assignment, ARF insertion; gop_structure.c — GF group
layout; ratectrl.c — Q selection, here encoder/ratectrl.py).

Structure per GF group of length L (after the key frame):

    [hidden ARF  = source frame t+L-1, refs {LAST},      refresh arf_slot]
    [P frame t+0, refs {LAST, ALTREF}, refresh last_slot]
    ...
    [P frame t+L-2, refs {LAST, ALTREF}, refresh last_slot]
    [show_existing(arf_slot)]          <- displays frame t+L-1

after which the ARF becomes LAST for the next group (slot roles swap).
The ARF is coded at a boosted (lower) qindex — the GF-boost analog —
which propagates quality through the group via prediction.

Temporal-unit packing: the hidden ARF OBU rides in the same TU as the
first P frame (one shown frame per TU), matching aomenc's packing.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c
from ..bitstream import headers as H
from .encoder import make_sequence_header
from .inter import InterFrameEncoder, make_inter_frame_header
from .lossy import LossyAllIntraEncoder, make_lossy_frame_header
from .ratectrl import MODE_Q, RateControl, RateControlConfig


class GopEncoder:
    """Rate-controlled GOP encoder (host RD path or device batched path)."""

    def __init__(self, width: int, height: int,
                 rc_cfg: RateControlConfig | None = None,
                 qindex: int = 60, gf_length: int = 8,
                 kf_interval: int = 120, use_arf: bool = True,
                 use_tpu: bool = False, use_native=None,
                 block_size: int = c.BLOCK_16X16,
                 enable_cdef: bool = True, tune: str = "psnr",
                 luma_bias: float = 0.0, twopass_stats=None,
                 enable_tf: bool = True, enable_tpl: bool = True,
                 bit_depth: int = 8, q_offsets=None,
                 interp_search: bool = False, comp_pred: bool = False,
                 order_hint: bool = True, motion_modes: bool = True,
                 compound_types: bool | None = None,
                 interintra: bool | None = None,
                 jnt_comp: bool = False,
                 cpu_used: int | None = None, seq_tools=None,
                 lf_sharpness: int = 0,
                 frame_parallel: bool = False, mesh=None,
                 sframe_dist: int = 0):
        self.tune = tune
        self.luma_bias = luma_bias
        self.order_hint = order_hint
        # cpu-used preset overrides the individual knobs
        # (speed_features.c:2240 analog, encoder/speed.py)
        self.sf = None
        if cpu_used is not None:
            from .speed import (adjust_framesize, adjust_qindex,
                                speed_features_for)
            sf = speed_features_for(cpu_used)
            sf = adjust_framesize(sf, width, height)
            sf = adjust_qindex(sf, qindex)
            self.sf = sf
            motion_modes = sf.motion_modes
            comp_pred = sf.comp_search
            interp_search = sf.interp_search
            enable_tf = sf.enable_tf
            enable_tpl = sf.enable_tpl
            block_size = max(block_size, sf.min_block)
            if compound_types is None:
                compound_types = sf.compound_types
            if interintra is None:
                interintra = sf.interintra
        # masked compound (wedge/diffwtd) rides on the explicit compound
        # search; interintra rides on single-ref RD (compound_type.c)
        if compound_types is None:
            compound_types = False
        if interintra is None:
            interintra = False
        # distance-weighted compound implies the explicit compound
        # search and needs order hints (host RD path)
        comp_pred = comp_pred or (jnt_comp and not use_tpu)
        compound_types = compound_types and comp_pred and not use_tpu
        interintra = interintra and not use_tpu
        jnt_comp = jnt_comp and comp_pred and order_hint and not use_tpu
        self.motion_modes = motion_modes
        self.sh = make_sequence_header(width, height,
                                       enable_cdef=int(enable_cdef),
                                       bit_depth=bit_depth,
                                       order_hint=order_hint,
                                       warped_motion=motion_modes,
                                       masked_compound=compound_types,
                                       jnt_comp=jnt_comp,
                                       interintra=interintra,
                                       **(seq_tools or {}))
        if rc_cfg is None:
            rc_cfg = RateControlConfig(mode=MODE_Q, fixed_qindex=qindex,
                                       width=width, height=height)
        rc_cfg.width, rc_cfg.height = width, height
        self.rc = RateControl(rc_cfg)
        self.gf_length = gf_length
        self.kf_interval = kf_interval
        self.use_arf = use_arf
        self.use_tpu = use_tpu
        self.use_native = use_native
        self.block_size = block_size
        self.slots = [None] * 8          # slot -> (y, u, v) recon planes
        # bitstream-state mirror per slot (decoder _update_ref_state):
        # frame context (CDF carry), order hint, global motion params
        self.slot_fc = [None] * 8
        self.slot_hint = [0] * 8
        self.slot_gm = [None] * 8
        # temporal-MVP source state per slot (decoder stored-buf mirror:
        # order_hint / ref_order_hints / frame_type / mi_dims / mvs)
        self.slot_buf = [None] * 8
        self.last_slot = 0
        self.arf_slot = 1
        self.twopass_stats = twopass_stats
        self.q_offsets = q_offsets
        self.lf_sharpness = lf_sharpness
        self.enable_tf = enable_tf
        self.enable_tpl = enable_tpl
        self.interp_search = interp_search
        self.comp_pred = comp_pred
        self._targets = None             # per-display-frame bit budgets
        self._tp_planned = 0.0           # two-pass plan realized so far
        self._tp_spent = 0.0
        self._tpl_maps = None            # per-group rdmult scale maps
        # FPMT mode (av1_compress_parallel_frames, ethread.c:1224): the
        # group's P frames reference only the fixed (anchor, ARF) pair,
        # making them independent -> shardable over a 'frame' mesh axis
        self.frame_parallel = frame_parallel and use_tpu
        self.mesh = mesh
        # S-frame cadence (aom_encoder.h:785 sframe_dist): every Nth
        # display frame in low-delay coding becomes a SWITCH_FRAME
        self.sframe_dist = sframe_dist

    # --- single-frame encoders -----------------------------------------

    def _search_kw(self, kw: dict, allowed: tuple) -> dict:
        """Apply control-registry overrides (api.resolve_tools 'search')
        on top of the speed-preset kw — the oxcf->cpi->sf lowering of
        av1/av1_cx_iface.c ctrl state."""
        ov = getattr(self, "search_overrides", None)
        if ov:
            kw.update({k: v for k, v in ov.items() if k in allowed})
        return kw

    def _encode_key(self, planes, qindex: int, order_hint: int = 0) -> bytes:
        # framesize-dependent KEY path pick on the device route (the
        # reference's av1_set_speed_features_framesize_dependent
        # analog, speed_features.c:2202): the device-RDO intra
        # (partition DP over 8..64, full mode set, TX_MODE_SELECT
        # depth search) runs up to SD; above that its per-SB host walk
        # grows with the frame and the fixed-16 wavefront keeps the KEY
        # off the critical path.
        rdo_ok = False
        if self.use_tpu:
            area = self.sh.max_frame_width * self.sh.max_frame_height
            # <= SD (KEYs amortize over kf_interval in production
            # either way; ROADMAP "resolution gates" re-measures this
            # threshold on the GPU)
            rdo_ok = (area <= 720 * 576
                      and (self.sf is None or self.sf.cpu_used <= 6)
                      and self.sh.bit_depth == 8)
        # host RD keys and device-RDO keys get the TX_MODE_SELECT
        # depth search (the wavefront path keeps LARGEST: its batched
        # trial is per-SB)
        tx_sel = (rdo_ok if self.use_tpu
                  else (self.sf is None or self.sf.tx_select))
        force = getattr(self, "force_tx_select", None)
        if force is not None and not self.use_tpu:
            tx_sel = force
        fh = make_lossy_frame_header(self.sh, qindex,
                                     tx_select=tx_sel,
                                     order_hint=order_hint,
                                     backward_update=self.order_hint)
        fh.sharpness_level = self.lf_sharpness
        if self.use_tpu:
            if rdo_ok:
                from .tpu_rdo import TpuRdoAllIntraEncoder
                enc = TpuRdoAllIntraEncoder(self.sh, fh,
                                            use_native=self.use_native)
            else:
                from .tpu_intra import TpuAllIntraEncoder
                enc = TpuAllIntraEncoder(self.sh, fh,
                                         use_native=self.use_native)
        else:
            kw = {}
            if self.sf is not None:
                kw = dict(mode_set=self.sf.mode_set,
                          trellis=self.sf.trellis,
                          rect_parts=self.sf.rect_parts,
                          ext_parts=self.sf.ext_parts,
                          speed=self.sf.ml_partition_prune,
                          tx_search=self.sf.tx_search)
            self._search_kw(kw, ("mode_set", "trellis", "rect_parts",
                                 "ext_parts", "tx_search", "enable_cfl",
                                 "sharpness"))
            enc = LossyAllIntraEncoder(self.sh, fh,
                                       use_native=self.use_native,
                                       block_size=self.block_size,
                                       tune=self.tune,
                                       luma_bias=self.luma_bias, **kw)
        payload = enc.encode_frame(planes)
        self._store_recon(enc, 0xFF, fh)
        return payload

    def _encode_inter(self, planes, qindex: int, ref_list,
                      refresh_slot: int, show: bool,
                      rdmult_map=None, order_hint: int = 0,
                      ext_results=None, s_frame: bool = False) -> bytes:
        """Returns the frame OBU bytes only (caller packs the TU)."""
        ref_frame_idx = [0] * 7
        ref_frame_idx[c.LAST_FRAME - 1] = self.last_slot
        ref_frame_idx[c.ALTREF_FRAME - 1] = self.arf_slot
        ref_frame_idx[c.GOLDEN_FRAME - 1] = self.last_slot
        filt = c.EIGHTTAP_REGULAR
        if self.interp_search and self.slots[self.last_slot] is not None:
            from .inter import pick_interp_filter
            filt = pick_interp_filter(planes[0],
                                      self.slots[self.last_slot][0],
                                      bd=self.sh.bit_depth)
        if ext_results is not None and isinstance(ext_results[0], dict):
            # device chain frames pick the frame filter on device
            # (interp_search.c analog inside _p_frame_core); the header
            # must signal what the device predicted with
            filt = int(ext_results[0].get("filt", c.EIGHTTAP_REGULAR))
        # primary ref = LAST (ref list index 0): CDF carry + backward
        # adaptation when the sequence has order hints
        primary = (0 if (self.order_hint and not s_frame
                         and self.slot_fc[self.last_slot] is not None)
                   else H.PRIMARY_REF_NONE)
        fh = make_inter_frame_header(
            self.sh, qindex,
            refresh_frame_flags=(0 if refresh_slot is None
                                 else 1 << refresh_slot),
            ref_frame_idx=ref_frame_idx, show_frame=int(show),
            showable_frame=int(not show), interp_filter=filt,
            tx_select=not self.use_tpu,
            comp=((self.comp_pred or self.order_hint) and not self.use_tpu
                  and c.ALTREF_FRAME in ref_list),
            order_hint=order_hint, primary_ref=primary,
            s_frame=s_frame,
            ref_order_hints=tuple(self.slot_hint),
            prev_gm_params=self.slot_gm[self.last_slot],
            motion_modes=self.motion_modes and not self.use_tpu)
        fh.sharpness_level = self.lf_sharpness
        if self.use_tpu:
            from .tpu_inter import TpuInterFrameEncoder
            # the device path's emitter derives MV predictors spatially;
            # signal use_ref_frame_mvs=0 so the decoder derives the same
            # stack (no temporal-MVP candidates)
            fh.allow_ref_frame_mvs = 0
            enc = TpuInterFrameEncoder(self.sh, fh, self.slots,
                                       use_native=self.use_native,
                                       ref_list=ref_list)
            if ext_results is not None:
                # device-chained frame (GF-group batch): the device
                # program already applied the in-loop deblock at the
                # q-derived level the header signals (ops/deblock_jnp),
                # so the host must not re-filter the fetched recon.
                # ext_results = (raw (B, 390) buffer, recon planes);
                # per-block dicts are built lazily only if the Python
                # emitter fallback runs (the native walker reads raw)
                enc._recon_prefiltered = True
                enc._external_results = True
                enc._res_raw = ext_results[0]
                enc._external_recon = ext_results[1]
        else:
            kw = {}
            if self.sf is not None:
                kw = dict(trellis=self.sf.trellis,
                          search_range=self.sf.search_range)
            self._search_kw(kw, ("trellis", "search_range", "sharpness"))
            enc = InterFrameEncoder(self.sh, fh, self.slots,
                                    use_native=self.use_native,
                                    block_size=self.block_size,
                                    ref_list=ref_list, tune=self.tune,
                                    luma_bias=self.luma_bias,
                                    comp_search=self.comp_pred,
                                    ref_bufs=self.slot_buf, **kw)
            if self.sf is not None:
                enc.search_method = self.sf.search_method
                enc.rect_parts = self.sf.rect_parts
                enc.speed = self.sf.ml_partition_prune
            ov = getattr(self, "search_overrides", None)
            if ov and "rect_parts" in ov:
                enc.rect_parts = ov["rect_parts"]
        if fh.primary_ref_frame != H.PRIMARY_REF_NONE:
            enc.fc0 = self.slot_fc[self.last_slot]
        if rdmult_map is not None:
            enc.ext_rdmult_map = rdmult_map
        obu = enc.encode_frame_obu(planes)
        self._store_recon(enc, fh.refresh_frame_flags, fh)
        return obu

    def _store_recon(self, enc, refresh_flags: int, fh) -> None:
        w, h = self.sh.max_frame_width, self.sh.max_frame_height
        cw, ch = (w + 1) >> 1, (h + 1) >> 1
        out = (enc.recon[0][:h, :w].copy(),
               enc.recon[1][:ch, :cw].copy(),
               enc.recon[2][:ch, :cw].copy())
        # stored frame context (decoder _update_ref_state mirror): the
        # tile-end adapted CDFs with backward refresh, else the initial
        if fh.disable_frame_end_update_cdf:
            from ..bitstream.tables import FrameContext
            fc_store = (enc.fc0.copy() if enc.fc0 is not None
                        else FrameContext(fh.base_q_idx))
        else:
            fc_store = enc.fc.copy()
            fc_store.reset_counters()
        if fh.is_intra:
            ref_hints_of = (0,) * 7
        else:
            ref_hints_of = tuple(self.slot_hint[fh.ref_frame_idx[i]]
                                 for i in range(7))
        h2 = (enc.mi_rows + 1) >> 1
        w2 = (enc.mi_cols + 1) >> 1
        mvs = (enc.frame_mvs_ref.copy(), enc.frame_mvs.copy()) \
            if hasattr(enc, "frame_mvs_ref") \
            else (np.full((h2, w2), -1, np.int8),
                  np.zeros((h2, w2, 2), np.int16))
        buf = {
            "order_hint": fh.order_hint,
            "ref_order_hints": ref_hints_of,
            "frame_type": fh.frame_type,
            "mi_dims": (enc.mi_rows, enc.mi_cols),
            "mvs": mvs,
        }
        for slot in range(8):
            if refresh_flags & (1 << slot):
                self.slots[slot] = out
                self.slot_fc[slot] = fc_store
                self.slot_hint[slot] = fh.order_hint
                self.slot_gm[slot] = fh.gm_params
                self.slot_buf[slot] = buf

    # --- sequence driver ------------------------------------------------

    def _build_schedule(self, n: int) -> list:
        """[('key', i) | ('gf', start, L)] covering display order.

        With two-pass stats: scene-cut key-frame placement + adaptive
        GF-group lengths from prediction decay (find_next_key_frame /
        define_gf_group, pass2_strategy.c:2034,2441); without stats the
        fixed kf_interval / gf_length cadence."""
        from .pass2 import adaptive_gf_length, find_key_frames
        stats = self.twopass_stats
        use_stats = stats is not None and len(stats) >= n
        keys = None
        if use_stats:
            keys = set(k for k in find_key_frames(
                stats[:n], kf_max=self.kf_interval) if k < n)
        sched = []
        i = 0
        while i < n:
            is_key = (i in keys) if keys is not None \
                else (i % self.kf_interval == 0)
            if is_key:
                sched.append(("key", i))
                i += 1
                continue
            if keys is not None:
                until_kf = min((k - i for k in keys if k > i),
                               default=n - i)
            else:
                until_kf = self.kf_interval - (i % self.kf_interval)
            limit = min(self.gf_length, n - i, until_kf)
            L = limit
            if use_stats and limit >= 2:
                L = min(adaptive_gf_length(stats, i, limit,
                                           self.gf_length), limit)
            sched.append(("gf", i, L))
            i += L
        return sched

    def _frame_kinds(self, n: int) -> list:
        """Display-order frame kinds for the scheduling rule below."""
        kinds = ["inter"] * n
        for item in self._build_schedule(n):
            if item[0] == "key":
                kinds[item[1]] = "key"
            elif self.use_arf and item[2] >= 3:
                kinds[item[1] + item[2] - 1] = "arf"
        return kinds

    def _q(self, kind: str, display_idx: int) -> int:
        """RC q plus the optional per-frame third-pass offset."""
        q = self.rc.pick_q(kind, self._target(display_idx))
        if self.q_offsets is not None and display_idx < len(self.q_offsets):
            q = max(self.rc.cfg.best_q,
                    min(self.rc.cfg.worst_q,
                        q + int(self.q_offsets[display_idx])))
        return q

    def _target(self, display_idx: int):
        if self._targets is None:
            return None
        t = float(self._targets[display_idx])
        # VBR rate correction (av1_twopass_postencode_update /
        # vbr_rate_correction analog, pass2_strategy.c:4075): scale the
        # remaining plan by the realized-vs-planned ratio so the
        # sequence converges on the exact budget instead of drifting
        # with the model error
        if self._tp_planned > 1.0:
            total = float(self._targets.sum())
            rem_planned = max(total - self._tp_planned, 1.0)
            rem_budget = total - self._tp_spent
            t *= min(2.0, max(0.5, rem_budget / rem_planned))
        return max(t, 64.0)

    def _tp_note(self, display_idx: int, bits: float) -> None:
        """Two-pass postencode bookkeeping (planned vs realized)."""
        if self._targets is None:
            return
        if display_idx < len(self._targets):
            self._tp_planned += float(self._targets[display_idx])
        self._tp_spent += float(bits)

    def _slot_state(self):
        return (list(self.slots), list(self.slot_fc),
                list(self.slot_hint), list(self.slot_gm),
                list(self.slot_buf), self.last_slot, self.arf_slot)

    def _restore_slot_state(self, st):
        (self.slots, self.slot_fc, self.slot_hint, self.slot_gm,
         self.slot_buf, self.last_slot, self.arf_slot) = \
            (list(st[0]), list(st[1]), list(st[2]), list(st[3]),
             list(st[4]), st[5], st[6])

    def _recode(self, kind: str, display_idx: int, q: int, encode_fn):
        """encode_with_recode_loop (encoder.c:2779): re-encode while the
        frame size misses its target beyond the tolerance, walking q
        with the observed bits/qstep ratio.  Every attempt starts from
        the same ref-slot state (an attempt's own refresh must not leak
        into the next attempt's ref hints / CDF carry / TMVP bufs — the
        decoder only ever sees the final attempt)."""
        rc = self.rc
        target = self._target(display_idx)
        # ALLOW_RECODE_KFARFGF (speed_features.h): only key/ARF frames
        # re-encode; P frames ride the feedback loop instead
        if kind == "inter":
            return encode_fn(q), q
        if target is None and rc.cfg.mode not in (0, 1):  # VBR/CBR only
            return encode_fn(q), q
        if target is None:
            target = rc.frame_target(kind)
        q_low, q_high = rc.cfg.best_q, rc.cfg.worst_q
        over = under = False
        st0 = self._slot_state()
        p = encode_fn(q)
        best = (abs(len(p) * 8 - target), p, q)
        for _ in range(rc.cfg.max_recodes):
            bits = len(p) * 8
            if not rc.need_recode(bits, target):
                break
            if bits > target:
                q_low = min(q + 1, q_high)
                over = True
            else:
                q_high = max(q - 1, q_low)
                under = True
            if q_low > q_high:
                break
            if over and under:
                # bracketed: bisect (the 1/qstep model overshoots on
                # steep rate curves and would oscillate)
                nq = (q_low + q_high) // 2
            else:
                nq = rc.regulate_q(q, bits, target, q_low, q_high)
            if nq == q:
                break
            q = nq
            self._restore_slot_state(st0)
            p = encode_fn(q)
            if abs(len(p) * 8 - target) < best[0]:
                best = (abs(len(p) * 8 - target), p, q)
        if best[1] is not p:
            # the ref slot holds the LAST attempt's recon; re-encode at
            # the winning q so payload and reference state agree
            self._restore_slot_state(st0)
            best = (best[0], encode_fn(best[2]), best[2])
        return best[1], best[2]

    def _adapt_kf_boost(self, frames) -> None:
        """Content-adaptive KEY boost (kf_boost, pass2_strategy.c): the
        more static the sequence, the finer the KEY — on near-static
        content the optimal strategy is a near-transparent anchor that
        every inter frame then inherits by skipping."""
        from .ratectrl import MODE_Q
        if self.rc.cfg.mode != MODE_Q or len(frames) < 2:
            return
        diffs = []
        for a, b in zip(frames[:-1], frames[1:]):
            ya = np.asarray(a[0][::4, ::4], np.int32)
            yb = np.asarray(b[0][::4, ::4], np.int32)
            diffs.append(float(np.mean(np.abs(ya - yb))))
        motion = float(np.median(diffs))
        # motion ~0 (static) -> 0.30; motion >= 6 (busy) -> 0.60
        self.rc.kf_boost_ratio = float(
            np.clip(0.30 + 0.05 * motion, 0.30, 0.60))

    def encode_sequence(self, frames) -> list:
        """Encode all frames; returns one payload per display frame."""
        n = len(frames)
        self._adapt_kf_boost(frames)
        if self.twopass_stats is not None:
            from .pass2 import TwoPassAllocator
            alloc = TwoPassAllocator(self.twopass_stats,
                                     self.rc.cfg.target_bps,
                                     self.rc.cfg.fps)
            self._targets = alloc.frame_targets(self._frame_kinds(n))
        payloads = []
        for item in self._build_schedule(n):
            if item[0] == "key":
                i = item[1]
                q = self._q("key", i)
                p, q = self._recode("key", i, q,
                                    lambda qq, f=frames[i], d=i:
                                    self._encode_key(f, qq,
                                                     order_hint=d & 127))
                self.rc.postencode("key", q, len(p) * 8)
                self._tp_note(i, len(p) * 8)
                self.last_slot, self.arf_slot = 0, 1
                payloads.append(p)
                continue
            _, i, L = item
            if self.use_arf and L >= 3:
                payloads.extend(self._encode_gf_group(frames[i:i + L], i))
            else:
                for j in range(L):
                    s_fr = bool(self.sframe_dist and (i + j) > 0
                                and (i + j) % self.sframe_dist == 0)
                    if self.rc.should_drop_frame("inter"):
                        # CBR frame drop (av1_rc_drop_frame): no TU is
                        # emitted; the bucket refills one frame's worth
                        self.rc.postencode_drop()
                        payloads.append(b"")
                        continue
                    q = self._q("inter", i + j)
                    obu, q = self._recode(
                        "inter", i + j, q,
                        lambda qq, f=frames[i + j], d=i + j, sf=s_fr:
                        self._encode_inter(
                            f, qq, (c.LAST_FRAME,), self.last_slot,
                            show=True, order_hint=d & 127, s_frame=sf))
                    tu = H.temporal_delimiter() + obu
                    self.rc.postencode("inter", q, len(tu) * 8)
                    self._tp_note(i + j, len(tu) * 8)
                    payloads.append(tu)
        return payloads

    def _encode_gf_group(self, group, base_idx: int = 0) -> list:
        """ARF-first coding of one GF group; returns display-order TUs."""
        from ..utils.profiler import profile
        L = len(group)
        q_arf = self._q("arf", base_idx + L - 1)

        # device source cache: upload each source frame ONCE (async) —
        # TPL, the temporal filter and the chain encode all reuse the
        # device-resident planes instead of re-uploading per consumer.
        dev_group = group
        use_dev_cache = (self.use_tpu and group[0][0].dtype == np.uint8
                         and self.sh.max_frame_width % 16 == 0
                         and self.sh.max_frame_height % 16 == 0)
        if use_dev_cache:
            import jax
            with profile("gop/upload"):
                dev_group = [tuple(jax.device_put(p) for p in f)
                             for f in group]
        tf_group = dev_group if use_dev_cache else group

        # TPL dependency pass (av1_tpl_setup_stats analog): deepen the
        # ARF q boost by how much the group references it, and build
        # per-frame rdmult maps
        tpl_maps = [None] * L
        if self.enable_tpl and L >= 2:
            from .tpl import tpl_gf_group, tpl_q_offset
            with profile("gop/tpl"):
                importance, tpl_maps = tpl_gf_group(dev_group, L - 1)
            # bounded ARF boost (av1_get_arf_q analog): the TPL offset
            # is capped and the ARF never codes finer than the KEY
            # anchor + margin — an unbounded boost makes the ARF
            # re-spend the whole key budget at near-lossless q
            dq = max(-16, tpl_q_offset(importance[L - 1], q_arf))
            q_arf = max(self.rc.cfg.best_q, q_arf + dq,
                        self.rc.last_q_key + 4)

        # ALTREF temporal filtering (av1_temporal_filter analog);
        # on the device path the group's source planes were uploaded once
        # (tf_group below) and the filter consumes the device copies
        arf_src = group[L - 1]
        if self.enable_tf and L >= 3:
            from .temporal_filter import temporal_filter
            with profile("gop/temporal_filter"):
                arf_src = temporal_filter(tf_group, L - 1, q_arf)

        dev_ok = (self.use_tpu
                  and self.sh.max_frame_width % 16 == 0
                  and self.sh.max_frame_height % 16 == 0)

        def _arf_try(qq):
            """One ARF encode at q: on the device path the frame runs
            through the SAME device program as the chain (1-frame
            chain: merge DP + device deblock + device-resident refs)
            instead of a single-frame dispatch and a host filter."""
            oh = (base_idx + L - 1) & 127
            if not dev_ok:
                return self._encode_inter(
                    arf_src, qq, (c.LAST_FRAME,), self.arf_slot,
                    show=False, rdmult_map=tpl_maps[L - 1],
                    order_hint=oh)
            from ..common.loopfilter import pick_filter_level_from_q
            from ..ops.inter_tpu import DeviceChainEncoder
            lf = pick_filter_level_from_q(qq, frame_is_key=False,
                                          bd=self.sh.bit_depth)
            raws, recons = DeviceChainEncoder().encode_chain(
                [arf_src], [qq], self.slots[self.last_slot], None,
                recon="all", lf_levels=[lf],
                sharpness=self.lf_sharpness)
            return self._encode_inter(
                arf_src, qq, (c.LAST_FRAME,), self.arf_slot,
                show=False, order_hint=oh,
                ext_results=(raws[0], recons[0]))

        with profile("gop/arf_encode"):
            arf_obu, q_arf = self._recode(
                "arf", base_idx + L - 1, q_arf, _arf_try)
        self.rc.postencode("arf", q_arf, len(arf_obu) * 8)
        self._tp_note(base_idx + L - 1, len(arf_obu) * 8)
        # device-chained group encode (use_tpu): ONE device program runs
        # all L-1 P frames (ops/inter_tpu.DeviceChainEncoder); per-frame
        # q is precomputed, the FPMT property (av1_cx_iface.c:3374)
        chain = None
        fpmt = False
        if (self.use_tpu and L >= 2
                and self.sh.max_frame_width % 16 == 0
                and self.sh.max_frame_height % 16 == 0):
            qs = [self._q("inter", base_idx + j) for j in range(L - 1)]
            if self.enable_tpl and L >= 2:
                # per-frame TPL q offset (av1_tpl_get_qstep_ratio analog
                # applied to the P chain, halved: a P frame that the
                # rest of the group leans on gets a finer quantizer)
                from .tpl import tpl_q_offset
                for j in range(L - 1):
                    dq = max(-8, tpl_q_offset(importance[j], qs[j]) // 2)
                    qs[j] = max(self.rc.cfg.best_q, qs[j] + dq,
                                self.rc.last_q_key + 4)
            # in-loop deblock levels for the device program: the same
            # q-derived LPF_PICK_FROM_Q estimate the headers will carry
            from ..common.loopfilter import pick_filter_level_from_q
            lfs = [pick_filter_level_from_q(q, frame_is_key=False,
                                            bd=self.sh.bit_depth)
                   for q in qs]
            if self.frame_parallel:
                from ..parallel.sharding import fpmt_encode_group
                with profile("gop/chain_device"):
                    raws, recons = fpmt_encode_group(
                        self.mesh, dev_group[:L - 1], qs,
                        self.slots[self.last_slot],
                        self.slots[self.arf_slot], lf_levels=lfs,
                        sharpness=self.lf_sharpness)
                fpmt = True
            else:
                from ..ops.inter_tpu import DeviceChainEncoder
                with profile("gop/chain_device"):
                    raws, recons = DeviceChainEncoder().encode_chain(
                        dev_group[:L - 1], qs, self.slots[self.last_slot],
                        self.slots[self.arf_slot], lf_levels=lfs,
                        sharpness=self.lf_sharpness)
            chain = (qs, raws, recons)
        tus = []
        for j in range(L - 1):
            if chain is not None:
                q = chain[0][j]
                with profile("gop/emit"):
                    obu = self._encode_inter(
                        group[j], q, (c.LAST_FRAME, c.ALTREF_FRAME),
                        None if fpmt else self.last_slot, show=True,
                        order_hint=(base_idx + j) & 127,
                        ext_results=(chain[1][j], chain[2][j]))
            else:
                q = self._q("inter", base_idx + j)
                obu, q = self._recode(
                    "inter", base_idx + j, q,
                    lambda qq, f=group[j], m=tpl_maps[j], d=base_idx + j:
                    self._encode_inter(
                        f, qq, (c.LAST_FRAME, c.ALTREF_FRAME),
                        self.last_slot, show=True, rdmult_map=m,
                        order_hint=d & 127))
            tu = H.temporal_delimiter() + (arf_obu if j == 0 else b"") + obu
            # charge only this frame's bits (the ARF's were already
            # accounted at its own postencode)
            self.rc.postencode("inter", q,
                               (len(tu) - (len(arf_obu) if j == 0 else 0))
                               * 8)
            self._tp_note(base_idx + j,
                          (len(tu) - (len(arf_obu) if j == 0 else 0)) * 8)
            tus.append(tu)
        # display the ARF; it becomes LAST for the next group
        tus.append(H.temporal_delimiter()
                   + H.show_existing_frame_obu(self.arf_slot))
        if L == 1:
            tus = [H.temporal_delimiter() + arf_obu + tus[-1]]
        self.last_slot, self.arf_slot = self.arf_slot, self.last_slot
        return tus


def encode_gop_ivf(path: str, frames, width: int, height: int,
                   fps=(30, 1), **kw) -> None:
    """Encode frames with GOP structure + rate control into IVF."""
    from ..bitstream.ivf import write_ivf
    enc = GopEncoder(width, height, **kw)
    payloads = enc.encode_sequence(frames)
    write_ivf(path, [(p, i) for i, p in enumerate(payloads) if p],
              width, height, fps[0], fps[1])


def encode_twopass_ivf(path: str, frames, width: int, height: int,
                       fps=(30, 1), stats_path: str | None = None,
                       **kw) -> None:
    """Two-pass encode: stats pass (firstpass.py), optional stats file
    round-trip, then pass 2 with closed-form bit allocation."""
    from ..bitstream.ivf import write_ivf
    from .firstpass import first_pass, load_stats, save_stats
    stats = first_pass(frames)
    if stats_path is not None:
        save_stats(stats_path, stats)
        stats = load_stats(stats_path)
    enc = GopEncoder(width, height, twopass_stats=stats, **kw)
    payloads = enc.encode_sequence(frames)
    write_ivf(path, [(p, i) for i, p in enumerate(payloads)],
              width, height, fps[0], fps[1])
