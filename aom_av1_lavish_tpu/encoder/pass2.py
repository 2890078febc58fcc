"""Pass 2: bit allocation from first-pass stats.

Re-design of av1/encoder/pass2_strategy.c
(av1_get_second_pass_params :3664, define_gf_group :2441): per-frame
complexity weights from the stats drive both the GF-group ARF boost and
per-frame bit targets; the total budget is the exact sequence budget so
two-pass hits the target rate closed-form instead of through the
one-pass feedback loop.
"""

from __future__ import annotations

import numpy as np


class TwoPassAllocator:
    """Distributes the sequence bit budget over frames by complexity."""

    def __init__(self, stats, target_bps: float, fps: float,
                 kf_boost: float = 4.0, arf_boost: float = 2.0,
                 exponent: float = 0.7):
        self.stats = stats
        self.fps = fps
        n = len(stats)
        self.total_bits = target_bps * n / fps
        # complexity weight: coded error, compressed (frames with huge
        # error shouldn't swallow the whole budget — pass2's bit-per-MB
        # clamping analog)
        err = np.array([max(s.coded_error, 1.0) for s in stats])
        self.weights = err ** exponent
        self.kf_boost = kf_boost
        self.arf_boost = arf_boost
        self._spent = 0.0
        self._alloc_done = 0

    def frame_targets(self, kinds) -> np.ndarray:
        """kinds: per-frame 'key'|'arf'|'inter' labels in coding order
        mapped to display indices; returns per-frame bit targets."""
        w = self.weights.copy()
        for i, k in enumerate(kinds):
            if k == "key":
                w[i] *= self.kf_boost
            elif k == "arf":
                w[i] *= self.arf_boost
        return self.total_bits * w / w.sum()

    def gf_group_boost(self, start: int, length: int) -> float:
        """ARF boost from in-group motion coherence (define_gf_group
        flavor): low coded/intra ratio => strong prediction => boost."""
        s = self.stats[start:start + length]
        if not s:
            return self.arf_boost
        ratios = [max(x.coded_error, 1.0) / max(x.intra_error, 1.0)
                  for x in s]
        coherence = 1.0 - float(np.mean(ratios))   # 1 = perfectly predicted
        return float(np.clip(1.5 + 2.5 * coherence, 1.2, 4.0))


# ---------------------------------------------------------------------------
# Stats-driven frame scheduling (find_next_key_frame / test_candidate_kf,
# pass2_strategy.c:2034; define_gf_group interval logic :2441)

def _pred_ratio(s) -> float:
    """coded/intra error ratio: ~0 = perfectly inter-predicted, ~1 = no
    better than intra (a prediction break)."""
    return max(s.coded_error, 1.0) / max(s.intra_error, 1.0)


def find_key_frames(stats, kf_min: int = 4, kf_max: int = 120) -> list:
    """Display indices that should be coded as key frames.

    test_candidate_kf analog: a frame is a scene cut when its inter
    prediction collapses (high coded/intra ratio or few inter-winning
    MBs) after a stretch of well-predicted frames.  kf_max forces a key
    frame like the reference's fixed upper bound."""
    keys = [0]
    last = 0
    for i in range(1, len(stats)):
        s = stats[i]
        if i - last >= kf_max:
            keys.append(i)
            last = i
            continue
        if i - last < kf_min:
            continue
        r = _pred_ratio(s)
        prev_r = _pred_ratio(stats[i - 1])
        # prediction break: the coded/intra ratio jumps well above the
        # running level AND is absolutely significant (test_candidate_kf
        # uses the same relative this-vs-last error tests)
        if (r > 0.25 and r > 3.0 * prev_r
                and (s.pcnt_inter < 0.85 or r > 0.85)):
            keys.append(i)
            last = i
    return keys


def adaptive_gf_length(stats, start: int, limit: int,
                       max_len: int, min_len: int = 3) -> int:
    """GF-group length from prediction decay (define_gf_group's
    interval cut: stop extending when the accumulated prediction
    quality decays or motion becomes incoherent)."""
    L = 1
    decay_acc = 1.0
    while L < min(limit, max_len):
        s = stats[start + L]
        r = _pred_ratio(s)
        decay_acc *= max(0.0, 1.0 - r)
        # cut: this frame breaks prediction, or the group's accumulated
        # predictability dropped too far to be worth one more frame
        if r > 0.65 or s.pcnt_inter < 0.5 or decay_acc < 0.08:
            break
        L += 1
    return max(L, min(min_len, limit))
