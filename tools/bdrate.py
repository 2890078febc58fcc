"""BD-rate quality harness: ours vs reference aomenc at equal quality.

Analog of the reference's tools/visual_metrics.py + BD-rate reporting
used around test/end_to_end_psnr_test.cc: encode each clip at several
quantizers with both encoders, measure PSNR/SSIM of the *decoded* output
(stock aomdec for both, so the metric pipeline is shared), then compute
the Bjontegaard rate delta (negative = we need fewer bits at equal
quality).

Usage:  python tools/bdrate.py [--quick]   (writes BDRATE.json)
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

AOMENC = os.path.join(ROOT, ".oracle", "build", "aomenc")
AOMDEC = os.path.join(ROOT, ".oracle", "build", "aomdec")

W, H, N = 352, 288, 8


# ---------------------------------------------------------------------------
# content: three synthetic clips with distinct character (no real video is
# available in this environment; clips cover smooth, textured, structured)
# ---------------------------------------------------------------------------

def make_clips(n=N, w=W, h=H):
    rng = np.random.default_rng(0)
    clips = {}

    yy, xx = np.mgrid[0:h + n * 2, 0:w + n * 2]
    base = (128 + 60 * np.sin(yy / 17.0) * np.cos(xx / 23.0)
            + 40 * (xx % 97 < 40) + rng.normal(0, 3, yy.shape))
    base = base.clip(0, 255).astype(np.uint8)
    # chroma pans with luma (per-frame chroma noise is not video)
    cyy, cxx = np.mgrid[0:(h + n * 2) // 2, 0:(w + n * 2) // 2]
    cb = (128 + 35 * np.sin(cyy / 11.0 + 1.0) * np.cos(cxx / 19.0)
          + rng.normal(0, 2, cyy.shape)).clip(0, 255).astype(np.uint8)
    cr = (128 + 30 * np.cos(cyy / 13.0) * np.sin(cxx / 7.0 + 2.0)
          + rng.normal(0, 2, cyy.shape)).clip(0, 255).astype(np.uint8)
    clips["mixed"] = [
        (np.ascontiguousarray(base[i:i + h, 2 * i:2 * i + w]),
         np.ascontiguousarray(cb[i // 2:i // 2 + h // 2, i:i + w // 2]),
         np.ascontiguousarray(cr[i // 2:i // 2 + h // 2, i:i + w // 2]))
        for i in range(n)]

    smooth = (120 + 80 * np.sin(yy / 61.0 + 0.5) * np.sin(xx / 83.0)) \
        .clip(0, 255).astype(np.uint8)
    clips["smooth"] = [
        (np.ascontiguousarray(smooth[i * 2:i * 2 + h, i:i + w]),
         np.full((h // 2, w // 2), 120, np.uint8),
         np.full((h // 2, w // 2), 130, np.uint8))
        for i in range(n)]

    blocks = np.kron(rng.integers(30, 226, ((h + n * 2) // 8 + 1,
                                            (w + n * 2) // 8 + 1)),
                     np.ones((8, 8)))[:h + n * 2, :w + n * 2]
    tex = (blocks + rng.normal(0, 12, blocks.shape)).clip(0, 255) \
        .astype(np.uint8)
    crows, ccols = h // 2 + n, w // 2 + n
    ctex = np.kron(rng.integers(60, 200, (crows // 8 + 1, ccols // 8 + 1)),
                   np.ones((8, 8)))[:crows, :ccols].astype(np.uint8)
    clips["texture"] = [
        (np.ascontiguousarray(tex[i:i + h, i * 2:i * 2 + w]),
         np.ascontiguousarray(ctex[i // 2:i // 2 + h // 2, i:i + w // 2]),
         np.ascontiguousarray(ctex[i:i + h // 2,
                                   i // 2:i // 2 + w // 2]))
        for i in range(n)]
    return clips


# ---------------------------------------------------------------------------
# metrics on decoded output
# ---------------------------------------------------------------------------

def decode_raw(path, tmpdir):
    out = os.path.join(tmpdir, "dec.yuv")
    subprocess.run([AOMDEC, "--rawvideo", "-o", out, path],
                   check=True, capture_output=True)
    return np.fromfile(out, np.uint8)


def rate_quality(path, frames, tmpdir, w=W, h=H):
    """(kbps@30fps, psnr_y, ssim_y) of an encoded ivf vs source."""
    from aom_av1_lavish_tpu.dsp.metrics import ssim as ssim_fn
    data = decode_raw(path, tmpdir)
    fs = w * h * 3 // 2
    mse = 0.0
    ssim = 0.0
    for i, f in enumerate(frames):
        y = data[i * fs:i * fs + w * h].reshape(h, w)
        mse += np.mean((y.astype(np.float64) - f[0]) ** 2)
        ssim += float(ssim_fn(f[0], y))
    n = len(frames)
    psnr = 10 * np.log10(255.0 ** 2 / (mse / n)) if mse else 99.0
    kbps = os.path.getsize(path) * 8 * 30.0 / n / 1000.0
    return kbps, psnr, ssim / n


def bd_rate(rate_ref, psnr_ref, rate_test, psnr_test):
    """Bjontegaard delta rate (%%, negative = test cheaper at equal
    quality).  Classic cubic fit of log-rate as a function of quality,
    integrated over the overlapping quality range."""
    lr_ref = np.log(np.asarray(rate_ref, np.float64))
    lr_test = np.log(np.asarray(rate_test, np.float64))
    p_ref = np.asarray(psnr_ref, np.float64)
    p_test = np.asarray(psnr_test, np.float64)
    pr = np.polyfit(p_ref, lr_ref, 3)
    pt = np.polyfit(p_test, lr_test, 3)
    lo = max(p_ref.min(), p_test.min())
    hi = min(p_ref.max(), p_test.max())
    if hi <= lo:
        return float("nan")
    ir = np.polyint(pr)
    it = np.polyint(pt)
    avg_ref = (np.polyval(ir, hi) - np.polyval(ir, lo)) / (hi - lo)
    avg_test = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return (np.exp(avg_test - avg_ref) - 1.0) * 100.0


# ---------------------------------------------------------------------------
# encoders under test
# ---------------------------------------------------------------------------

def enc_ours_allintra(path, frames, q, kind="device"):
    if kind == "device":
        from aom_av1_lavish_tpu.encoder.tpu_rdo import encode_tpu_rdo_ivf
        encode_tpu_rdo_ivf(path, frames, W, H, qindex=q, enable_cdef=1,
                           enable_restoration=1)
    elif kind == "wavefront":
        from aom_av1_lavish_tpu.encoder.tpu_intra import encode_tpu_ivf
        encode_tpu_ivf(path, frames, W, H, qindex=q)
    else:
        from aom_av1_lavish_tpu.encoder.lossy import encode_lossy_ivf
        encode_lossy_ivf(path, frames, W, H, qindex=q)


def enc_ours_gop(path, frames, q):
    from aom_av1_lavish_tpu.encoder.gop import encode_gop_ivf
    encode_gop_ivf(path, frames, W, H, qindex=q, gf_length=len(frames),
                   use_tpu=True, enable_cdef=True)


def enc_aomenc(path, frames, q, extra, tmpdir):
    from aom_av1_lavish_tpu.utils.y4m import write_y4m
    src = os.path.join(tmpdir, "src.y4m")
    write_y4m(src, frames, W, H)
    subprocess.run([AOMENC, "--threads=1", "--passes=1", "--cpu-used=6",
                    "--end-usage=q", f"--cq-level={q}"] + extra
                   + ["-o", path, src], check=True, capture_output=True)


# AV1 qindex ~ 4x the aomenc cq-level scale; spread the points so the
# quality curves overlap over a usable range (a saturated flat segment
# makes the Bjontegaard cubic fit meaningless)
Q_OURS = (60, 104, 152, 200)
Q_AOMENC = (15, 26, 38, 50)


def sweep(clip_frames, enc_fn, qs, tmpdir, tag):
    rates, psnrs, ssims = [], [], []
    t0 = time.perf_counter()
    for q in qs:
        path = os.path.join(tmpdir, f"{tag}_{q}.ivf")
        enc_fn(path, clip_frames, q)
        r, p, s = rate_quality(path, clip_frames, tmpdir)
        rates.append(r)
        psnrs.append(p)
        ssims.append(s)
    dt = time.perf_counter() - t0
    return dict(rates=rates, psnr=psnrs, ssim=ssims,
                fps=len(clip_frames) * len(qs) / dt)


def main():
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="one clip; wavefront all-intra instead of RDO")
    ap.add_argument("--gop", action="store_true",
                    help="include the inter-GOP sweep even with --quick")
    args = ap.parse_args()
    if not (os.path.exists(AOMENC) and os.path.exists(AOMDEC)):
        print(json.dumps({"error": "oracle binaries missing"}))
        return
    clips = make_clips()
    if args.quick:
        clips = {"mixed": clips["mixed"]}
    report = {}
    with tempfile.TemporaryDirectory() as td:
        for name, frames in clips.items():
            entry = {}
            ref = sweep(frames, lambda p, f, q: enc_aomenc(
                p, f, q, ["--kf-max-dist=1", "--kf-min-dist=1"], td),
                Q_AOMENC, td, f"{name}_ref_ai")
            ai_kind = "wavefront" if args.quick else "device"
            dev = sweep(frames, lambda p, f, q: enc_ours_allintra(
                p, f, q, ai_kind), Q_OURS, td, f"{name}_dev_ai")
            entry["allintra"] = dict(
                ref=ref, ours=dev,
                bd_rate_psnr=round(bd_rate(ref["rates"], ref["psnr"],
                                           dev["rates"], dev["psnr"]), 2),
                bd_rate_ssim=round(bd_rate(ref["rates"], ref["ssim"],
                                           dev["rates"], dev["ssim"]), 2))
            if args.gop or not args.quick:
                refg = sweep(frames, lambda p, f, q: enc_aomenc(
                    p, f, q, ["--lag-in-frames=8"], td),
                    Q_AOMENC, td, f"{name}_ref_gop")
                gop = sweep(frames, enc_ours_gop, Q_OURS, td,
                            f"{name}_gop")
                entry["inter_gop"] = dict(
                    ref=refg, ours=gop,
                    bd_rate_psnr=round(
                        bd_rate(refg["rates"], refg["psnr"],
                                gop["rates"], gop["psnr"]), 2),
                    bd_rate_ssim=round(
                        bd_rate(refg["rates"], refg["ssim"],
                                gop["rates"], gop["ssim"]), 2))
            report[name] = entry
    # aggregate
    agg = {}
    for mode in ("allintra", "inter_gop"):
        vals = [v[mode]["bd_rate_psnr"] for v in report.values()
                if mode in v and np.isfinite(v[mode]["bd_rate_psnr"])]
        if vals:
            agg[f"bd_rate_psnr_{mode}_avg"] = round(float(np.mean(vals)), 2)
        svals = [v[mode]["bd_rate_ssim"] for v in report.values()
                 if mode in v and np.isfinite(v[mode]["bd_rate_ssim"])]
        if svals:
            agg[f"bd_rate_ssim_{mode}_avg"] = round(float(np.mean(svals)),
                                                    2)
    report["aggregate"] = agg
    out = os.path.join(ROOT, "BDRATE.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["aggregate"] if agg else report, indent=1))


if __name__ == "__main__":
    main()
