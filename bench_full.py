"""Extended benchmark: all shipped encode configs, multiple resolutions,
quality (BD-rate) and validation records.

Writes BENCH_DETAIL.json (list of metric records) and prints it.  The
driver-facing single-line benchmark stays in bench.py; this script
tracks the full performance picture per round:

  * lossless all-intra (native walk + batched device analyze) + stages
  * lossy all-intra: device wavefront path and device-RDO quality path
  * inter GOP (KEY + ARF + P chain) at CIF / 720p / 1080p
  * realtime (device streaming path) at CIF / 1080p
  * decode throughput
  * speed-preset ladder (fps + PSNR per cpu-used)
  * BD-rate vs aomenc (tools/bdrate.py quick sweep)
  * device validation record (compiled-kernel conformance)

vs_baseline compares against the reference aomenc/aomdec (single
thread) on the same machine where the oracle binaries exist.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

W, H, N = 352, 288, 8
AOMENC = os.path.join(ROOT, ".oracle", "build", "aomenc")
AOMDEC = os.path.join(ROOT, ".oracle", "build", "aomdec")


def make_frames(n=N, w=W, h=H):
    """Synthetic pan: textured luma AND chroma move coherently frame to
    frame (per-frame chroma noise would make inter prediction useless
    on two of three planes, which no real video does)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h + n * 2, 0:w + n * 2]
    base = (128 + 60 * np.sin(yy / 17.0) * np.cos(xx / 23.0)
            + 40 * (xx % 97 < 40) + rng.normal(0, 3, yy.shape))
    base = base.clip(0, 255).astype(np.uint8)
    cyy, cxx = np.mgrid[0:(h + n * 2) // 2, 0:(w + n * 2) // 2]
    cb = (128 + 35 * np.sin(cyy / 11.0 + 1.0) * np.cos(cxx / 19.0)
          + rng.normal(0, 2, cyy.shape)).clip(0, 255).astype(np.uint8)
    cr = (128 + 30 * np.cos(cyy / 13.0) * np.sin(cxx / 7.0 + 2.0)
          + rng.normal(0, 2, cyy.shape)).clip(0, 255).astype(np.uint8)
    frames = []
    for i in range(n):
        y = np.ascontiguousarray(base[i:i + h, 2 * i:2 * i + w])
        u = np.ascontiguousarray(cb[i // 2:i // 2 + h // 2,
                                    i:i + w // 2])
        v = np.ascontiguousarray(cr[i // 2:i // 2 + h // 2,
                                    i:i + w // 2])
        frames.append((y, u, v))
    return frames


def timed(fn, *a, **kw):
    fn(*a, **kw)          # warm (jit compile)
    t0 = time.perf_counter()
    fn(*a, **kw)
    return time.perf_counter() - t0


def aomenc_fps(frames, tmpdir, args, w=W, h=H):
    from aom_av1_lavish_tpu.utils.y4m import write_y4m
    if not os.path.exists(AOMENC):
        return None
    src = os.path.join(tmpdir, f"src{w}.y4m")
    if not os.path.exists(src):
        write_y4m(src, frames, w, h)
    out = os.path.join(tmpdir, "ref.ivf")
    t0 = time.perf_counter()
    subprocess.run([AOMENC, "--threads=1", "--passes=1"] + args
                   + ["-o", out, src], check=True, capture_output=True)
    return len(frames) / (time.perf_counter() - t0)


def psnr_y(dec_frames, src_frames):
    mse = np.mean([np.mean((d[0].astype(np.float64)
                            - s[0].astype(np.float64)) ** 2)
                   for d, s in zip(dec_frames, src_frames)])
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def main():
    import tempfile
    from bench import require_gpu
    device = require_gpu()
    results = [dict(metric="device", value=device)]
    out_path = os.path.join(ROOT, "BENCH_DETAIL.json")

    def add(metric, value, unit=None, vs=None, **extra):
        rec = dict(metric=metric, value=value)
        if unit:
            rec["unit"] = unit
        if vs is not None:
            rec["vs_baseline"] = round(vs, 3)
        rec.update(extra)
        results.append(rec)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        print(json.dumps(rec), flush=True)

    frames = make_frames()
    td_obj = tempfile.TemporaryDirectory()
    td = td_obj.name

    # 1. lossless all-intra --------------------------------------------
    from aom_av1_lavish_tpu.encoder import encode_lossless_ivf
    out = os.path.join(td, "l.ivf")
    dt = timed(encode_lossless_ivf, out, frames, W, H)
    ref = aomenc_fps(frames, td, ["--enable-chroma-deltaq=0",
                                  "--aq-mode=0", "--lossless=1",
                                  "--cpu-used=6", "--kf-max-dist=1",
                                  "--kf-min-dist=1"])
    v = N / dt
    add("lossless_allintra_352x288", round(v, 3), "frames/s",
        v / ref if ref else None)

    from aom_av1_lavish_tpu.encoder.encoder import (
        LosslessEncoder, make_lossless_frame_header, make_sequence_header)
    from aom_av1_lavish_tpu.ops.lossless import analyze_frames_for_encoder
    sh = make_sequence_header(W, H)
    encs, srcs = [], []
    for f in frames:
        e = LosslessEncoder(sh, make_lossless_frame_header(sh))
        srcs.append(e.pad_planes(f))
        encs.append(e)
    dt_an = timed(analyze_frames_for_encoder, srcs)
    an = analyze_frames_for_encoder(srcs)
    t0 = time.perf_counter()
    for e, f, a in zip(encs, frames, an):
        e.encode_frame(f, analysis=a)
    add("lossless_stage_analyze_ms_per_frame",
        round(dt_an / N * 1000, 2), "ms")
    add("lossless_stage_walk_ms_per_frame",
        round((time.perf_counter() - t0) / N * 1000, 2), "ms")

    # 2. lossy all-intra (device wavefront) ----------------------------
    from aom_av1_lavish_tpu.encoder.tpu_intra import encode_tpu_ivf
    out2 = os.path.join(td, "ai.ivf")
    dt = timed(encode_tpu_ivf, out2, frames, W, H, 60)
    ref = aomenc_fps(frames, td, ["--cpu-used=6", "--end-usage=q",
                                  "--cq-level=40", "--kf-max-dist=1",
                                  "--kf-min-dist=1"])
    ref_ai = ref
    v = N / dt
    add("lossy_allintra_tpu_352x288", round(v, 3), "frames/s",
        v / ref if ref else None)

    # 2b. lossy all-intra, device RDO (quality path) — 4 frames (slow)
    from aom_av1_lavish_tpu.encoder.tpu_rdo import encode_tpu_rdo_ivf
    out2b = os.path.join(td, "rdo.ivf")
    rdo_frames = frames[:2]
    dt = timed(encode_tpu_rdo_ivf, out2b, rdo_frames, W, H, 80)
    v = len(rdo_frames) / dt
    add("lossy_allintra_rdo_352x288", round(v, 3), "frames/s",
        v / ref_ai if ref_ai else None)

    # 3. inter GOP (device chain) at CIF / 720p / 1080p ----------------
    from aom_av1_lavish_tpu.encoder.gop import encode_gop_ivf
    from aom_av1_lavish_tpu.utils import profiler
    for (w, h, tag) in ((W, H, "352x288"), (1280, 720, "1280x720"),
                        (1920, 1088, "1920x1088")):
        fr = frames if (w, h) == (W, H) else make_frames(n=N, w=w, h=h)
        outg = os.path.join(td, f"gop{w}.ivf")

        def run_gop(fr=fr, w=w, h=h, outg=outg):
            encode_gop_ivf(outg, fr, w, h, qindex=60, gf_length=8,
                           use_tpu=True, enable_cdef=False)
        run_gop()                       # warm (jit compile)
        profiler.enable()
        profiler.reset()
        t0 = time.perf_counter()
        run_gop()
        dt = time.perf_counter() - t0
        stage = {k.split("/")[-1]: round(v * 1000 / N, 2)
                 for k, v in profiler.times().items()
                 if k.startswith("gop/") or k.startswith("encode/")}
        profiler.enable(False)
        with tempfile.TemporaryDirectory() as td2:
            ref = aomenc_fps(fr, td2, ["--cpu-used=6", "--end-usage=q",
                                       "--cq-level=40",
                                       "--lag-in-frames=8"], w=w, h=h)
        v = N / dt
        add(f"inter_gop_tpu_{tag}", round(v, 3), "frames/s",
            v / ref if ref else None, stage_ms_per_frame=stage)

    # 4. realtime (device streaming) at CIF / 1080p --------------------
    from aom_av1_lavish_tpu.encoder.nonrd import (encode_realtime_ivf,
                                                  encode_realtime_tpu_ivf)
    for (w, h, tag) in ((W, H, "352x288"), (1920, 1088, "1920x1088")):
        fr = frames if (w, h) == (W, H) else make_frames(n=N, w=w, h=h)
        outr = os.path.join(td, f"rt{w}.ivf")
        dt = timed(encode_realtime_tpu_ivf, outr, fr, w, h, 90)
        with tempfile.TemporaryDirectory() as td2:
            ref = aomenc_fps(fr, td2, ["--cpu-used=9", "--end-usage=q",
                                       "--cq-level=50",
                                       "--lag-in-frames=0", "--usage=1"],
                             w=w, h=h)
        v = N / dt
        add(f"rtc_tpu_{tag}", round(v, 3), "frames/s",
            v / ref if ref else None)
        if (w, h) == (W, H):
            ref_rt_cif = ref
    # host non-RD path kept as the feature-complete RT reference
    out4 = os.path.join(td, "rth.ivf")
    dt = timed(encode_realtime_ivf, out4, frames, W, H, 90)
    v = N / dt
    add("rtc_nonrd_host_352x288", round(v, 3), "frames/s",
        v / ref_rt_cif if ref_rt_cif else None)

    # 5. decode throughput on the lossless stream ----------------------
    from aom_av1_lavish_tpu.decoder import decode_ivf
    dt = timed(decode_ivf, out)
    refv = None
    if os.path.exists(AOMDEC):
        t0 = time.perf_counter()
        subprocess.run([AOMDEC, "-o", os.path.join(td, "d.y4m"), out],
                       check=True, capture_output=True)
        refv = N / (time.perf_counter() - t0)
    v = N / dt
    add("decode_lossless_352x288", round(v, 3), "frames/s",
        v / refv if refv else None)

    # 6. speed-preset ladder (host quality path, 4 CIF frames) ---------
    lf = frames[:2]
    for cpu in (2, 5, 8):
        outs = os.path.join(td, f"sp{cpu}.ivf")

        def run_sp(cpu=cpu, outs=outs):
            encode_gop_ivf(outs, lf, W, H, qindex=60, gf_length=2,
                           cpu_used=cpu)
        t0 = time.perf_counter()
        run_sp()
        dt = time.perf_counter() - t0
        dec = decode_ivf(outs)
        add(f"speed_ladder_cpu{cpu}", round(len(lf) / dt, 3), "frames/s",
            None, psnr=round(psnr_y(dec, lf), 2),
            bytes=os.path.getsize(outs))

    # 7. BD-rate vs aomenc (quick sweep: all-intra + GOP, mixed clip) --
    if os.path.exists(AOMENC) and os.path.exists(AOMDEC):
        r = subprocess.run([sys.executable,
                            os.path.join(ROOT, "tools", "bdrate.py"),
                            "--quick", "--gop"],
                           capture_output=True, text=True)
        bd_path = os.path.join(ROOT, "BDRATE.json")
        if r.returncode == 0 and os.path.exists(bd_path):
            with open(bd_path) as f:
                bd = json.load(f).get("aggregate", {})
            for k, val in bd.items():
                add(k, val, "percent")
        else:
            add("bdrate_error", (r.stderr or "")[-300:])

    # 8. device validation: compiled kernels must produce streams
    # stock aomdec accepts bit-exactly (the SIMD-vs-C contract run on
    # the real backend — conformance subset, not interpreter mode)
    try:
        from aom_av1_lavish_tpu.utils.y4m import read_y4m
        ok = None
        if os.path.exists(AOMDEC):
            checks = []
            for path, fr in ((os.path.join(td, "gop352.ivf"), frames),
                             (os.path.join(td, f"rt{W}.ivf"), frames),
                             (out2, frames)):
                if not os.path.exists(path):
                    continue
                o2 = os.path.join(td, "val.y4m")
                subprocess.run([AOMDEC, "-o", o2, path], check=True,
                               capture_output=True)
                ours = decode_ivf(path)
                refd = read_y4m(o2)[0]
                checks.append(all(
                    np.array_equal(a, b)
                    for fo, fr2 in zip(ours, refd)
                    for a, b in zip(fo, fr2)))
            ok = bool(checks) and all(checks)
        add("tpu_validation", "pass" if ok else "fail",
            device=device, streams_checked=len(checks) if ok is not None
            else 0)
    except Exception as e:                            # pragma: no cover
        add("tpu_validation", f"error: {e}")

    td_obj.cleanup()
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
