"""Benchmark: 1080p inter-GOP encode throughput on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"}.  value = our end-to-end GOP encode fps (1920x1088 4:2:0,
KEY + ARF + chained P frames, in-loop deblock, native entropy coding);
vs_baseline = ours / aomenc single-thread fps at the matching config
(cpu-used=6, --lag-in-frames; 1.0 when the oracle binary is absent).
`device` names what ran it (platform, device_kind, count); the script
refuses to run anywhere but on a GPU.  The full matrix (CIF/720p,
all-intra, RT, decode, BD-rate) lives in bench_full.py.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

W, H, N_FRAMES = 1920, 1088, 8
QINDEX = 120


def make_frames(n=N_FRAMES, w=W, h=H):
    """Synthetic pan: textured luma AND chroma move coherently (matches
    bench_full.py / tools/bdrate.py content)."""
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
        frames.append((
            np.ascontiguousarray(base[i:i + h, 2 * i:2 * i + w]),
            np.ascontiguousarray(cb[i // 2:i // 2 + h // 2, i:i + w // 2]),
            np.ascontiguousarray(cr[i // 2:i // 2 + h // 2,
                                    i:i + w // 2])))
    return frames


def bench_ours(frames, tmpdir):
    from aom_av1_lavish_tpu.encoder.gop import encode_gop_ivf
    out = os.path.join(tmpdir, "ours.ivf")
    kw = dict(qindex=QINDEX, gf_length=N_FRAMES, use_tpu=True,
              enable_cdef=False)
    encode_gop_ivf(os.path.join(tmpdir, "warm.ivf"), frames, W, H, **kw)
    t0 = time.perf_counter()
    encode_gop_ivf(out, frames, W, H, **kw)
    dt = time.perf_counter() - t0
    return len(frames) / dt


def bench_aomenc(frames, tmpdir):
    from aom_av1_lavish_tpu.utils.y4m import write_y4m
    aomenc = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          ".oracle", "build", "aomenc")
    if not os.path.exists(aomenc):
        return None
    src = os.path.join(tmpdir, "src.y4m")
    write_y4m(src, frames, W, H)
    out = os.path.join(tmpdir, "ref.ivf")
    t0 = time.perf_counter()
    subprocess.run(
        [aomenc, "--cpu-used=6", "--threads=1", "--passes=1",
         "--end-usage=q", f"--cq-level={QINDEX // 4}",
         f"--lag-in-frames={N_FRAMES}",
         "-o", out, src], check=True, capture_output=True)
    dt = time.perf_counter() - t0
    return len(frames) / dt


def require_gpu() -> dict:
    """The device record of this run; exits when JAX finds no GPU (a
    number taken anywhere else is not a measurement of the system)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main():
    device = require_gpu()
    frames = make_frames()
    with tempfile.TemporaryDirectory() as tmpdir:
        ours = bench_ours(frames, tmpdir)
        try:
            ref = bench_aomenc(frames, tmpdir)
        except Exception:
            ref = None
    vs = ours / ref if ref else 1.0
    print(json.dumps({
        "metric": "inter_gop_encode_1920x1088",
        "value": round(ours, 3),
        "unit": "frames/s",
        "vs_baseline": round(vs, 4),
        "device": device,
    }))


if __name__ == "__main__":
    main()
