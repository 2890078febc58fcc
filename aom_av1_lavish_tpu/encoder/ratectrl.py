"""Single-pass rate control: per-frame Q selection + buffer model.

Re-design of libaom's one-pass rate controller (reference
behavior: av1/encoder/ratectrl.c — av1_rc_pick_q_and_bounds :2093,
av1_rc_postencode_update :2202, av1_rc_update_rate_correction_factors,
av1_rc_bits_per_mb; buffer model av1_rc_init / update_buffer_level).

The controller is a pure host-side feedback loop (control flow is
data-dependent and tiny — exactly the part that should NOT live in the
jitted graph).  The model:

    predicted_bits(q) = n_mb * C(frame_type) * correction / qstep(q)

with the per-frame-type correction factor learned online from the ratio
of actual to predicted bits (the same inverse-q first-order model the
reference uses).  CBR keeps a leaky-bucket buffer; frame targets bend
toward restoring the optimal buffer level.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common import quant as Q

# rate-control modes (aom_encoder.h:184-187)
MODE_VBR = 0
MODE_CBR = 1
MODE_CQ = 2
MODE_Q = 3

MIN_Q = 1
MAX_Q = 255

# bits-per-MB model numerators at qstep == 1 (learned online via the
# correction factor; these only set the starting operating point)
_BPMB_NUM_KEY = 2200.0
_BPMB_NUM_INTER = 1400.0


def qstep_of(qindex: int) -> float:
    """AC quantizer step in pixel units for 8-bit."""
    return max(Q.ac_quant_qtx(qindex, 0) / 8.0, 0.25)


@dataclass
class RateControlConfig:
    target_bps: int = 400_000
    fps: float = 30.0
    width: int = 352
    height: int = 288
    mode: int = MODE_CBR
    worst_q: int = 255
    best_q: int = 4
    # leaky bucket, in milliseconds of stream (aomenc --buf-*-sz analogs)
    buf_initial_ms: int = 4000
    buf_optimal_ms: int = 5000
    buf_sz_ms: int = 6000
    # frame-size clamps as % of per-frame bandwidth (rc_min/max_quantizer
    # analog of rc_min_frame_bandwidth / rc_max_inter_bitrate_pct)
    min_frame_pct: int = 5
    max_frame_pct: int = 800
    # fixed q for MODE_Q
    fixed_qindex: int = 60
    # recode loop (encode_with_recode_loop): re-encode a frame whose
    # size lands outside +-recode_tolerance% of its target
    recode: bool = True
    recode_tolerance: int = 25
    max_recodes: int = 3
    # CBR drop-frame watermark as % of the optimal buffer level
    # (aomenc --drop-frame; av1_rc_drop_frame, ratectrl.c): 0 = never
    drop_frames_water_mark: int = 0


@dataclass
class RateControl:
    cfg: RateControlConfig
    # learned correction factors per frame class
    cf_key: float = 1.0
    cf_inter: float = 1.0
    cf_arf: float = 1.0
    buffer_level: float = 0.0
    frames_coded: int = 0
    last_q_inter: int = 60
    last_q_key: int = 60
    #: MODE_Q KEY q ratio (content-adaptive kf boost; the GOP driver
    #: lowers it toward 0.3 for static sequences)
    kf_boost_ratio: float = 0.55
    total_bits: int = 0
    # accumulated VBR debt (bits we owe / are owed vs the target)
    bits_off_target: float = 0.0
    # CBR frame-drop state (av1_rc_drop_frame decimation analog)
    consec_drops: int = 0
    dropped_frames: int = 0
    # anti-limit-cycle state: last two inter (q, bits, target) points
    inter_hist: list = field(default_factory=list)
    inter_since_key: bool = True

    def __post_init__(self):
        c = self.cfg
        self.per_frame_bandwidth = c.target_bps / c.fps
        self.buffer_level = c.target_bps * c.buf_initial_ms / 1000.0
        self.optimal_level = c.target_bps * c.buf_optimal_ms / 1000.0
        self.maximum_buffer = c.target_bps * c.buf_sz_ms / 1000.0
        self.n_mb = ((c.width + 15) // 16) * ((c.height + 15) // 16)

    # --- model ---------------------------------------------------------

    def _cf(self, frame_kind: str) -> float:
        return {"key": self.cf_key, "arf": self.cf_arf}.get(
            frame_kind, self.cf_inter)

    def _set_cf(self, frame_kind: str, v: float) -> None:
        v = min(max(v, 0.05), 20.0)
        if frame_kind == "key":
            self.cf_key = v
        elif frame_kind == "arf":
            self.cf_arf = v
        else:
            self.cf_inter = v

    def predicted_bits(self, qindex: int, frame_kind: str) -> float:
        num = _BPMB_NUM_KEY if frame_kind == "key" else _BPMB_NUM_INTER
        return self.n_mb * num * self._cf(frame_kind) / qstep_of(qindex)

    # --- frame targets (av1_calc_{i,p}frame_target_size_one_pass_cbr) --

    def frame_target(self, frame_kind: str) -> float:
        c = self.cfg
        if frame_kind == "key":
            # keyframe boost, tapered by buffer headroom
            boost = 6.0 if self.frames_coded == 0 else 4.0
            target = self.per_frame_bandwidth * boost
        elif frame_kind == "arf":
            target = self.per_frame_bandwidth * 2.5
        else:
            target = self.per_frame_bandwidth
        if c.mode == MODE_CBR:
            # bend toward the optimal buffer level, at most
            # under/over_shoot_pct/200 of the nominal target per frame
            # (av1_calc_pframe_target_size_one_pass_cbr's exact rule —
            # a steeper bend starves frames to the minimum and the
            # achieved rate never reaches the target)
            diff = self.optimal_level - self.buffer_level
            one_pct = max(self.optimal_level / 100.0, 1.0)
            shoot_pct = 25.0    # aomenc --undershoot/overshoot-pct
            if diff > 0:
                pct = min(diff / one_pct, shoot_pct)
                target -= target * pct / 200.0
            elif diff < 0:
                pct = min(-diff / one_pct, shoot_pct)
                target += target * pct / 200.0
        else:
            # VBR: pay back a fraction of the accumulated debt
            target = max(target - self.bits_off_target * 0.05, 0.0)
        lo = self.per_frame_bandwidth * c.min_frame_pct / 100.0
        hi = self.per_frame_bandwidth * c.max_frame_pct / 100.0
        return min(max(target, lo), hi)

    # --- q selection (av1_rc_pick_q_and_bounds one-pass) ---------------

    def pick_q(self, frame_kind: str,
               ext_target_bits: float | None = None) -> int:
        """ext_target_bits: externally allocated frame budget (two-pass
        path, av1_get_second_pass_params analog) — overrides the
        one-pass buffer-model target."""
        c = self.cfg
        if ext_target_bits is not None:
            if frame_kind == "inter":
                self._picked_inter_target = ext_target_bits
            lo, hi = c.best_q, c.worst_q
            while lo < hi:
                mid = (lo + hi) // 2
                if self.predicted_bits(mid, frame_kind) > ext_target_bits:
                    lo = mid + 1
                else:
                    hi = mid
            return min(max(lo, c.best_q), c.worst_q)
        if c.mode == MODE_Q:
            if frame_kind == "key":
                # kf boost (get_kf_active_quality, ratectrl.c): the KEY
                # is the whole pyramid's anchor — code it much finer
                # than the operating point so inter frames become cheap
                # deltas (a weak KEY forces the ARF to re-spend the
                # bits at boosted q, costing more total).  The ratio is
                # content-adaptive (kf_boost from stats,
                # pass2_strategy.c): static sequences get a near-
                # transparent KEY that every frame then inherits by
                # skipping.
                return max(c.best_q,
                           int(c.fixed_qindex * self.kf_boost_ratio))
            if frame_kind == "arf":
                return max(c.best_q, int(c.fixed_qindex * 0.85))
            return c.fixed_qindex
        target = self.frame_target(frame_kind)
        if frame_kind == "inter":
            # remember the target this frame is actually coded against;
            # postencode stores it in inter_hist (computing it after the
            # buffer update would record the NEXT frame's target)
            self._picked_inter_target = target
        # binary search the monotone inverse-q model
        lo, hi = c.best_q, c.worst_q
        while lo < hi:
            mid = (lo + hi) // 2
            if self.predicted_bits(mid, frame_kind) > target:
                lo = mid + 1
            else:
                hi = mid
        q = lo
        # stability clamp: inter frames move at most +-16 steps per frame
        if frame_kind != "key" and self.frames_coded > 0:
            last = self.last_q_inter
            q = min(max(q, last - 16), last + 16)
        if frame_kind == "inter":
            # post-key floor: the inter model has no observations yet
            # and the key's q is the only anchor — inter frames at CBR
            # never run finer than the key (av1 active_best_quality
            # derivation from avg_frame_qindex, ratectrl.c)
            if not self.inter_since_key:
                q = max(q, self.last_q_key + 8)
            # anti-limit-cycle: when the last two inter frames bracket
            # the target from opposite sides, the 1/qstep model is
            # limit-cycling on a steep bits-vs-q region; bisect the
            # observed bracketing pair instead (the recode loop's
            # over&under rule, applied across frames)
            if len(self.inter_hist) >= 2:
                q1, b1, t1 = self.inter_hist[-1]
                q0, b0, t0 = self.inter_hist[-2]
                if (b1 > t1) != (b0 > t0) and abs(q1 - q0) >= 2 \
                        and not (min(q0, q1) <= q <= max(q0, q1)):
                    # only override when the model's q escapes the
                    # observed bracket — inside it the model is already
                    # interpolating the same pair
                    q = (q1 + q0 + 1) // 2
        if c.mode == MODE_CBR and frame_kind != "key":
            # underflow guard (calc_active_worst_quality_one_pass_cbr,
            # ratectrl.c): as the buffer drains below 30% of optimal,
            # push the operating point toward worst_q — OVERRIDING the
            # per-frame step limit, a draining bucket cannot wait
            crit = 0.3 * self.optimal_level
            if self.buffer_level < crit:
                frac = 1.0 - max(self.buffer_level, 0.0) / max(crit, 1.0)
                q = min(c.worst_q, q + int(frac * 32.0))
        if frame_kind == "arf":
            # ARF rides below the inter operating point (GF boost)
            q = max(c.best_q, min(q, self.last_q_inter) - 12)
        return min(max(q, c.best_q), c.worst_q)

    # --- frame dropping (av1_rc_drop_frame, ratectrl.c) -----------------

    def should_drop_frame(self, frame_kind: str = "inter") -> bool:
        """CBR drop decision: drop when the buffer has drained below the
        watermark (ratectrl.c av1_rc_drop_frame's decimation, simplified
        to a bounded consecutive-drop rule).  Call postencode_drop()
        after acting on a True result."""
        c = self.cfg
        if (c.mode != MODE_CBR or not c.drop_frames_water_mark
                or frame_kind == "key" or self.frames_coded == 0):
            self.consec_drops = 0
            return False
        mark = c.drop_frames_water_mark / 100.0 * self.optimal_level
        if self.buffer_level <= mark and self.consec_drops < 2:
            return True
        self.consec_drops = 0
        return False

    def postencode_drop(self) -> None:
        """Buffer update for a dropped frame: the bucket refills by one
        frame of bandwidth and nothing is spent."""
        self.buffer_level = min(self.buffer_level
                                + self.per_frame_bandwidth,
                                self.maximum_buffer)
        self.bits_off_target -= self.per_frame_bandwidth
        self.consec_drops += 1
        self.dropped_frames += 1
        self.frames_coded += 1

    # --- recode loop (encoder.c encode_with_recode_loop) ----------------

    def frame_size_bounds(self, target: float):
        """av1_rc_compute_frame_size_bounds: +-recode_tolerance% slack
        around the frame target."""
        if target is None or target <= 0:
            return 0.0, float("inf")
        slack = self.cfg.recode_tolerance / 100.0 * target
        return max(target - slack, 0.0), target + slack

    def regulate_q(self, q: int, actual_bits: float, target: float,
                   q_low: int, q_high: int) -> int:
        """recode_loop_update_q analog: rescale the quantizer step by
        the observed overshoot ratio (bits ~ 1/qstep), clamped to the
        loop's [q_low, q_high] window."""
        ratio = actual_bits / max(target, 1.0)
        want = qstep_of(q) * ratio
        lo, hi = q_low, q_high
        while lo < hi:
            mid = (lo + hi) // 2
            if qstep_of(mid) < want:
                lo = mid + 1
            else:
                hi = mid
        return min(max(lo, q_low), q_high)

    def need_recode(self, actual_bits: float, target) -> bool:
        if target is None or self.cfg.mode == MODE_Q \
                or not self.cfg.recode:
            return False
        lo, hi = self.frame_size_bounds(target)
        return actual_bits > hi or actual_bits < lo

    # --- postencode (av1_rc_postencode_update) -------------------------

    def postencode(self, frame_kind: str, qindex: int,
                   used_bits: int) -> None:
        predicted = self.predicted_bits(qindex, frame_kind)
        if predicted > 0:
            ratio = used_bits / predicted
            # damped multiplicative update, clamped per frame
            # (av1_rc_update_rate_correction_factors: a full update
            # limit-cycles when bits-vs-q is steep, an over-damped one
            # cannot hit CBR targets inside a buffer window)
            cf = self._cf(frame_kind) \
                * float(min(max(ratio, 0.4), 2.5)) ** 0.6
            self._set_cf(frame_kind, cf)
        self.buffer_level += self.per_frame_bandwidth - used_bits
        self.buffer_level = min(self.buffer_level, self.maximum_buffer)
        self.bits_off_target += used_bits - self.per_frame_bandwidth
        self.total_bits += used_bits
        if frame_kind == "key":
            self.last_q_key = qindex
            self.inter_since_key = False
            self.inter_hist.clear()
        else:
            self.last_q_inter = qindex
            if frame_kind == "inter":
                self.inter_since_key = True
                t = getattr(self, "_picked_inter_target", None)
                if t is None:
                    t = self.frame_target("inter")
                self.inter_hist.append((qindex, used_bits, t))
                del self.inter_hist[:-2]
        self.frames_coded += 1

    # --- reporting -----------------------------------------------------

    def achieved_bps(self) -> float:
        if self.frames_coded == 0:
            return 0.0
        return self.total_bits * self.cfg.fps / self.frames_coded
