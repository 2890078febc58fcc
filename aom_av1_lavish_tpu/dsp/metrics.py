"""Quality metrics: PSNR, SSIM, fast MS-SSIM-style multiscale, PSNR-HVS.

Batched re-design of the reference metric kernels (aom_dsp/psnr.c,
aom_dsp/ssim.c:aom_ssim2 — 8x8 windows stepped by 4, aom_dsp/fastssim.c
— multiscale SSIM, aom_dsp/psnrhvs.c — 8x8 DCT with CSF weighting).
Implemented as vectorized numpy on host with jax-compatible math; these
score full frames (the per-SB variants for rdmult tuning live in
encoder/tune.py).
"""

from __future__ import annotations

import numpy as np


def sse(a, b) -> float:
    d = a.astype(np.int64) - b.astype(np.int64)
    return float((d * d).sum())


def psnr(a, b, peak: float = 255.0) -> float:
    m = sse(a, b) / a.size
    if m <= 0:
        return 100.0
    return float(10.0 * np.log10(peak * peak / m))


def frame_psnr(frames_a, frames_b, peak: float = 255.0) -> dict:
    """Per-plane + combined PSNR over (y, u, v) tuples
    (aom_calc_psnr semantics: combined uses total SSE over all planes)."""
    tot_sse = 0.0
    tot_n = 0
    out = {}
    for name, pa, pb in zip("yuv", frames_a, frames_b):
        s = sse(pa, pb)
        out[name] = psnr(pa, pb, peak) if s else 100.0
        tot_sse += s
        tot_n += pa.size
    m = tot_sse / tot_n
    out["all"] = 100.0 if m <= 0 else float(
        10.0 * np.log10(peak * peak / m))
    return out


def _windows(x, win: int, step: int):
    """(H, W) -> (n, win, win) sliding windows."""
    H, W = x.shape
    ys = range(0, H - win + 1, step)
    xs = range(0, W - win + 1, step)
    out = np.empty((len(ys) * len(xs), win, win), x.dtype)
    i = 0
    for y in ys:
        for xx in xs:
            out[i] = x[y:y + win, xx:xx + win]
            i += 1
    return out


def ssim(a, b, peak: float = 255.0) -> float:
    """aom_ssim2 semantics: 8x8 windows stepped by 4, k1=0.01, k2=0.03."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    wa = _windows(a, 8, 4)
    wb = _windows(b, 8, 4)
    mu_a = wa.mean((1, 2))
    mu_b = wb.mean((1, 2))
    var_a = wa.var((1, 2))
    var_b = wb.var((1, 2))
    cov = (wa * wb).mean((1, 2)) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return float((num / den).mean())


# --- PSNR-HVS (aom_dsp/psnrhvs.c) -------------------------------------

# od_csf CSF weights for the 8x8 DCT bands (psnrhvs.c:36 csf_y)
_CSF_Y = np.array([
    [1.6193873005, 2.2901594831, 2.08509755623, 1.48366094411,
     1.00227514334, 0.678296995242, 0.466224900598, 0.3265091542],
    [2.2901594831, 1.94321815382, 2.04793073064, 1.68731108984,
     1.2305666963, 0.868920337363, 0.61280991668, 0.436405793551],
    [2.08509755623, 2.04793073064, 1.34329019223, 1.09205635862,
     0.875748795257, 0.670882927016, 0.501731932449, 0.372504254596],
    [1.48366094411, 1.68731108984, 1.09205635862, 0.772819797575,
     0.605636379554, 0.48309405692, 0.380429446972, 0.295774038565],
    [1.00227514334, 1.2305666963, 0.875748795257, 0.605636379554,
     0.448996256676, 0.352889268808, 0.283006984131, 0.226951348204],
    [0.678296995242, 0.868920337363, 0.670882927016, 0.48309405692,
     0.352889268808, 0.27032073436, 0.215017739696, 0.17408067321],
    [0.466224900598, 0.61280991668, 0.501731932449, 0.380429446972,
     0.283006984131, 0.215017739696, 0.168869545842, 0.136153931001],
    [0.3265091542, 0.436405793551, 0.372504254596, 0.295774038565,
     0.226951348204, 0.17408067321, 0.136153931001, 0.109083846276]])

_DCT8 = np.array([[np.cos((2 * k + 1) * n * np.pi / 16)
                   * (np.sqrt(0.125) if n == 0 else 0.5)
                   for k in range(8)] for n in range(8)])


def psnrhvs(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """PSNR-HVS-M style metric (aom_dsp/psnrhvs.c calc_psnrhvs): CSF-
    weighted 8x8 DCT-domain MSE with local masking, batched over all
    blocks at once."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    h, w = a.shape
    hb, wb = h // 8, w // 8
    if hb == 0 or wb == 0:
        return psnr(a, b, peak)
    av = a[:hb * 8, :wb * 8].reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3)
    bv = b[:hb * 8, :wb * 8].reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3)
    da = _DCT8 @ av @ _DCT8.T                # (hb, wb, 8, 8) DCT
    db = _DCT8 @ bv @ _DCT8.T
    # masking: mean AC energy of the source block scales tolerance
    # (psnrhvs.c s_masks, normalized per coefficient)
    ac = (da ** 2).sum((-1, -2)) - da[..., 0, 0] ** 2
    mask = np.sqrt(np.maximum(ac, 0.0) / 64.0) / 8.0
    d = np.abs(da - db)
    d = np.maximum(d - mask[..., None, None], 0.0)
    mse = ((d * _CSF_Y) ** 2).mean()
    if mse <= 1e-12:
        return 99.0
    return float(10 * np.log10(peak * peak / mse))


def fastssim(a: np.ndarray, b: np.ndarray, peak: float = 255.0,
             levels: int = 4) -> float:
    """Multi-scale FastSSIM (aom_dsp/fastssim.c): per-level SSIM on
    2x-downsampled pyramids combined with the standard MS-SSIM
    exponents."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    weights = [0.2989654541015625, 0.3141326904296875,
               0.2473602294921875, 0.1395416259765625][:levels]
    vals = []
    for lvl in range(levels):
        vals.append(ssim(a, b, peak))
        if lvl < levels - 1:
            a = (a[0::2, 0::2] + a[1::2, 0::2]
                 + a[0::2, 1::2] + a[1::2, 1::2])[:a.shape[0] // 2,
                                                  :a.shape[1] // 2] / 4.0
            b = (b[0::2, 0::2] + b[1::2, 0::2]
                 + b[0::2, 1::2] + b[1::2, 1::2])[:b.shape[0] // 2,
                                                  :b.shape[1] // 2] / 4.0
    vals = np.clip(vals, 1e-6, 1.0)
    return float(np.prod(np.asarray(vals) ** (np.asarray(weights)
                                              / sum(weights))))
