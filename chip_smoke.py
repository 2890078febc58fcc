"""Smoke test of the encoder's device path on a GPU.

    python chip_smoke.py            # one GPU: kernels, main path, the
                                    # other device paths, GPU vs CPU
    python chip_smoke.py --four     # four GPUs: FPMT and the sharded
                                    # lossless encoder against one device

Every phase prints one JSON line with its compile seconds (lowering and
XLA backend compilation, from jax.monitoring) and run seconds (the rest
of its wall time).  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
and is printed only when every phase passed.  The script exits non-zero,
printing no result, when JAX finds no GPU; it never falls back to
another platform.  Content is the seeded synthetic pan of bench.py.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
W1080, H1080 = 1920, 1088
WCIF, HCIF = 352, 288
QINDEX = 120
SEED = 0

#: lowering to MLIR and XLA's backend compilation, once per executable
#: (tracing is left out: nested jits record it again inside their
#: caller's trace)
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]


def _on_duration(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration


def check_device(devices, need: int) -> dict:
    """The device record of this run; SystemExit unless JAX's first
    device is a GPU and there are `need` of them."""
    plat = devices[0].platform
    if plat != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {plat!r}")
    if len(devices) < need:
        raise SystemExit(f"chip_smoke: needs {need} GPUs, JAX found "
                         f"{len(devices)}")
    return {"platform": plat, "kind": devices[0].device_kind,
            "count": len(devices)}


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip() or f"nvidia-smi failed: {r.stderr.strip()}"


_T0 = time.perf_counter()


def _emit(rec: dict) -> None:
    print(json.dumps(rec, default=str), flush=True)


def _log(msg: str) -> None:
    """A progress line: seconds since start, compile seconds so far."""
    print(f"[{time.perf_counter() - _T0:8.1f}s compile {_compile_s[0]:7.1f}s]"
          f" {msg}", flush=True)


def run_phase(name: str, fn) -> bool:
    c0, t0 = _compile_s[0], time.perf_counter()
    rec = {"phase": name}
    try:
        rec.update(fn() or {})
        rec["ok"] = True
    except Exception as e:                      # reported, then failed
        traceback.print_exc()
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    wall = time.perf_counter() - t0
    comp = _compile_s[0] - c0
    rec["compile_s"] = round(comp, 3)
    rec["run_s"] = round(wall - comp, 3)
    _emit(rec)
    return rec["ok"]


def _time(fn, *args, reps: int = 10) -> float:
    """Median wall ms of fn(*args) after one warm call, each call
    ended by block_until_ready."""
    import jax
    import numpy as np
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


# ---------------------------------------------------------------------------
# phase 1: kernels at real widths against their plain references


def numpy_ssd(src, win, bsz: int, radius: int):
    import numpy as np
    S = 2 * radius + 1
    s64 = src.astype(np.int64)
    w64 = win.astype(np.int64)
    corr = np.zeros((src.shape[0], S, S), np.int64)
    for i in range(bsz):
        for j in range(bsz):
            corr += s64[:, i, j, None, None] * w64[:, i:i + S, j:j + S]
    w2 = w64 * w64
    rs = sum(w2[:, i:i + S, :] for i in range(bsz))
    e_ref = sum(rs[:, :, j:j + S] for j in range(bsz))
    e_src = (s64 * s64).sum((1, 2))
    return e_src[:, None, None] + e_ref - 2 * corr


def phase_kernels() -> dict:
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from aom_av1_lavish_tpu.bitstream import constants as c
    from aom_av1_lavish_tpu.common import interpred as IP
    from aom_av1_lavish_tpu.common import txfm2d as T2
    from aom_av1_lavish_tpu.ops import pallas_kernels as PK
    from aom_av1_lavish_tpu.ops import txfm_jax as TJ

    rng = np.random.default_rng(SEED)
    out = {}
    B = (H1080 // 16) * (W1080 // 16)          # 8160 blocks at 1080p
    for name, bsz, r, peak in (("ssd_full_b16_r16", 16, 16, 255),
                               ("ssd_half_b8_r16", 8, 16, 4 * 255)):
        Wn = 2 * r + bsz
        src = rng.integers(0, peak + 1, (B, bsz, bsz)).astype(np.int32)
        win = rng.integers(0, peak + 1, (B, Wn, Wn)).astype(np.int32)
        src[0] = peak
        win[0, :bsz, :bsz] = 0
        sd, wd = jnp.asarray(src), jnp.asarray(win)
        op = jax.jit(partial(PK.ssd_surface, bsz=bsz, radius=r, peak=peak))
        got = np.asarray(op(sd, wd))
        want = numpy_ssd(src, win, bsz, r).astype(np.float32)
        assert np.array_equal(got, want), f"{name}: surface != numpy SSD"
        _log(f"{name} checked")
        out[name] = {"B": B, "xla_ms": _time(op, sd, wd)}

    Hp, Wp = H1080 + 128, W1080 + 128         # PADR-padded 1080p plane
    for wr, dtype in ((23, np.uint8), (25, np.uint8), (39, np.uint8),
                      (23, np.int32), (25, np.int32), (39, np.int32)):
        plane = rng.integers(0, 256, (Hp, Wp)).astype(dtype)
        br = rng.integers(0, Hp - wr, B).astype(np.int32)
        bc = rng.integers(0, Wp - wr, B).astype(np.int32)
        want = plane[br[:, None, None] + np.arange(wr)[None, :, None],
                     bc[:, None, None] + np.arange(wr)[None, None, :]]
        args = (jnp.asarray(plane), jnp.asarray(br), jnp.asarray(bc))
        op = jax.jit(partial(PK.gather_windows, wr=wr, wc=wr))
        assert np.array_equal(np.asarray(op(*args)), want), \
            f"gather {wr} {np.dtype(dtype).name} != numpy"
        out[f"gather_{wr}x{wr}_{np.dtype(dtype).name}"] = {
            "B": B, "xla_ms": _time(op, *args)}
    _log("gathers checked")
    filt = np.asarray(IP.SUBPEL_FILTERS_8)
    region = rng.integers(0, 256, (B, 23, 23)).astype(np.int32)
    sx, sy = rng.integers(0, 16, B), rng.integers(0, 16, B)
    conv = jax.jit(partial(PK.convolve_8tap, bh=16, bw=16))
    cargs = (jnp.asarray(region), jnp.asarray(filt[sx].astype(np.int32)),
             jnp.asarray(filt[sy].astype(np.int32)))
    got = np.asarray(conv(*cargs))
    for b in range(B):
        assert np.array_equal(got[b], IP.convolve_sr(
            region[b], int(sx[b]), int(sy[b]), filt, filt)), \
            f"convolve_8tap block {b} != interpred"
    out["convolve_8tap_16x16"] = {"B": B, "xla_ms": _time(conv, *cargs)}

    _log("convolve checked")
    nt = 256
    for ts in (c.TX_8X8, c.TX_16X16, c.TX_32X32, c.TX_64X64):
        h, w = c.TX_HEIGHT[ts], c.TX_WIDTH[ts]
        aw, ah = min(w, 32), min(h, 32)
        resid = rng.integers(-255, 256, (nt, h, w)).astype(np.int32)
        fwd = jax.jit(partial(TJ.fwd_txfm2d_batched, tx_size=ts,
                              tx_type=c.DCT_DCT))
        inv = jax.jit(partial(TJ.inv_txfm2d_add_batched, tx_size=ts,
                              tx_type=c.DCT_DCT))
        got = np.asarray(fwd(resid))
        for i in range(nt):
            assert np.array_equal(got[i], T2.fwd_txfm2d(
                resid[i], ts, c.DCT_DCT)), f"fwd txfm {w}x{h} block {i}"
        coeff = rng.integers(-(1 << 15), 1 << 15,
                             (nt, aw * ah)).astype(np.int32)
        pred = rng.integers(0, 256, (nt, h, w)).astype(np.uint8)
        got = np.asarray(inv(coeff, pred))
        for i in range(nt):
            assert np.array_equal(got[i], T2.inv_txfm2d_add(
                coeff[i], pred[i], ts, c.DCT_DCT)), \
                f"inv txfm {w}x{h} block {i}"
    out["txfm_fwd_inv"] = {"sizes": [8, 16, 32, 64], "blocks": nt}

    _log("transforms checked")
    out["rdo_intra_trial_cif"] = _trial_sweep_gpu_vs_cpu()
    return out


def _trial_sweep_gpu_vs_cpu() -> dict:
    """The device-RDO trial sweep at CIF on the GPU and on the CPU of
    the same process.  Costs are sse + lam * bits; the mode each block
    would pick (the argmin) must agree."""
    import jax
    import numpy as np

    import bench
    from aom_av1_lavish_tpu.ops.rdo_intra import IntraTrialEngine

    y = bench.make_frames(n=1, w=WCIF, h=HCIF)[0][0]
    sizes = [(8, 8), (16, 16), (32, 32), (8, 16), (16, 8)]

    def sweep():
        eng = IntraTrialEngine(80)
        return eng.trial_plane(y, sizes, lambda py, px, bh, bw: 60.0)

    gpu = sweep()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = sweep()
    exact = all(np.array_equal(gpu[k], cpu[k]) for k in sizes)
    max_rel = max(float(np.max(np.abs(gpu[k] - cpu[k])
                               / np.maximum(np.abs(cpu[k]), 1.0)))
                  for k in sizes)
    same_pick = all(np.array_equal(gpu[k].argmin(-1), cpu[k].argmin(-1))
                    for k in sizes)
    assert same_pick, f"trial sweep picks differ (max rel {max_rel})"
    return {"exact": exact, "max_rel_diff": max_rel,
            "same_mode_picks": same_pick}


# ---------------------------------------------------------------------------
# phase 2: the main path at 1080p


def _decode_all(payloads):
    from aom_av1_lavish_tpu.decoder.decoder import decode_frame_obus
    sh = None
    state = {"slots": [None] * 8}
    shown = []
    for p in payloads:
        if p:
            fr, sh = decode_frame_obus(p, sh, state)
            shown.extend(fr)
    return shown, state


def _psnr_y(dec, src) -> float:
    import numpy as np
    mse = np.mean([np.mean((d[0].astype(np.float64)
                            - s[0].astype(np.float64)) ** 2)
                   for d, s in zip(dec, src)])
    return 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def _check_slots(enc, state) -> int:
    import numpy as np
    n = 0
    for slot in range(8):
        if enc.slots[slot] is None:
            continue
        assert state["slots"][slot] is not None, f"slot {slot} missing"
        for pe, pd in zip(enc.slots[slot], state["slots"][slot]["planes"]):
            assert np.array_equal(pe, pd), \
                f"slot {slot}: decoder != encoder reconstruction"
        n += 1
    return n


def _chain_memory(n_p: int) -> dict:
    """memory_analysis() of the 1080p GF-group chain program."""
    import numpy as np

    from aom_av1_lavish_tpu.common import quant as Q
    from aom_av1_lavish_tpu.ops.inter_tpu import _p_chain_fn, _pq_array
    H, W = H1080, W1080
    fn = _p_chain_fn((H, W, 2, 0, True))
    pq = np.stack([np.stack(
        [_pq_array(Q.build_plane_quant(QINDEX, 0, 0))] * 3)] * n_p)
    y = np.zeros((H, W), np.uint8)
    uv = np.zeros((H // 2, W // 2), np.uint8)
    args = (np.zeros((n_p, H, W), np.uint8),
            np.zeros((n_p, H // 2, W // 2), np.uint8),
            np.zeros((n_p, H // 2, W // 2), np.uint8),
            y, uv, uv, y, uv, uv, pq, np.zeros((n_p, 3), np.int32),
            np.zeros(n_p, np.float32), np.zeros(n_p, np.int32))
    ma = fn.lower(*args).compile().memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def phase_main_path() -> dict:
    import jax

    import bench
    from aom_av1_lavish_tpu.api import Encoder, EncoderConfig
    from aom_av1_lavish_tpu.bitstream.ivf import read_ivf
    from aom_av1_lavish_tpu.encoder.gop import GopEncoder, encode_gop_ivf

    W, H = W1080, H1080
    frames = bench.make_frames(n=9, w=W, h=H)     # KEY + one 8-frame group
    kw = dict(qindex=QINDEX, gf_length=8, use_tpu=True)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "gop.ivf")
        t0 = time.perf_counter()
        encode_gop_ivf(path, frames, W, H, **kw)
        out["encode_gop_ivf_first_s"] = time.perf_counter() - t0
        first = [p for p, _ in read_ivf(path)]
    _log("encode_gop_ivf done")
    enc = GopEncoder(W, H, **kw)
    t0 = time.perf_counter()
    payloads = enc.encode_sequence(frames)
    out["encode_warm_s"] = time.perf_counter() - t0
    out["encode_warm_fps"] = len(frames) / out["encode_warm_s"]
    _log("GopEncoder done")
    second = [p for p in payloads if p]
    assert second == first, "two encodes of the same clip differ"
    out["stream_bytes"] = sum(map(len, first))
    shown, state = _decode_all(payloads)
    assert len(shown) == len(frames), f"decoded {len(shown)} frames"
    out["slots_checked"] = _check_slots(enc, state)
    out["psnr_y"] = _psnr_y(shown, frames)
    _log("decoded, slots checked")

    cfg = EncoderConfig(width=W, height=H, use_tpu=True, qindex=QINDEX,
                        gf_length=8)
    api_enc = Encoder(cfg)
    for f in frames:
        api_enc.encode(f)
    t0 = time.perf_counter()
    api_payloads = api_enc.flush()
    out["api_encode_s"] = time.perf_counter() - t0
    api_shown, _ = _decode_all(api_payloads)
    assert len(api_shown) == len(frames), "api stream: frames missing"
    out["api_psnr_y"] = _psnr_y(api_shown, frames)
    _log("api.Encoder done")

    out["chain_1080p_memory"] = _chain_memory(n_p=7)
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return out


# ---------------------------------------------------------------------------
# phase 3: the other device paths


def phase_other_paths() -> dict:
    import numpy as np

    import bench
    from aom_av1_lavish_tpu.decoder import decode_ivf
    from aom_av1_lavish_tpu.decoder.parallel import decode_ivf_parallel
    from aom_av1_lavish_tpu.encoder import encode_lossless_ivf
    from aom_av1_lavish_tpu.encoder.nonrd import encode_realtime_tpu_ivf
    from aom_av1_lavish_tpu.encoder.tpu_intra import encode_tpu_ivf
    from aom_av1_lavish_tpu.encoder.tpu_rdo import encode_tpu_rdo_ivf

    W, H = W1080, H1080
    frames = bench.make_frames(n=3, w=W, h=H)
    cif = bench.make_frames(n=1, w=WCIF, h=HCIF)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        def run(name, encode, fr, w, h, *a):
            p = os.path.join(td, name + ".ivf")
            t0 = time.perf_counter()
            encode(p, fr, w, h, *a)
            dt = time.perf_counter() - t0
            dec = decode_ivf(p)
            assert len(dec) == len(fr), f"{name}: decoded {len(dec)}"
            _log(f"{name} decoded")
            out[name] = {"frames": len(fr), "encode_s": dt,
                         "psnr_y": _psnr_y(dec, fr)}
            return p, dec

        p_ll, dec = run("lossless_1080p", encode_lossless_ivf,
                        frames[:3], W, H)
        for d, s in zip(dec, frames):
            for a, b in zip(d, s):
                assert np.array_equal(a, b), "lossless: decode != source"
        run("wavefront_allintra_1080p", encode_tpu_ivf, frames[:1], W, H,
            QINDEX)
        run("rdo_key_cif", encode_tpu_rdo_ivf, cif, WCIF, HCIF, 80)
        run("realtime_1080p", encode_realtime_tpu_ivf, frames[:3], W, H,
            90)
        par = decode_ivf_parallel(p_ll, workers=2)
        assert len(par) == len(dec) and all(
            np.array_equal(a, b) for x, y in zip(par, dec)
            for a, b in zip(x, y)), "parallel decode != serial decode"
        out["decode_ivf_parallel"] = {"frames": len(par)}
    return out


# ---------------------------------------------------------------------------
# phase 4: the same CIF clip on the GPU and on the CPU


def _stage_diffs(frames) -> dict:
    """Runs each device stage of a GF group on both devices with the
    same inputs and names the stages whose outputs differ."""
    import jax
    import numpy as np

    from aom_av1_lavish_tpu.encoder.temporal_filter import temporal_filter
    from aom_av1_lavish_tpu.encoder.tpl import tpl_gf_group
    from aom_av1_lavish_tpu.ops.inter_tpu import DeviceChainEncoder
    from aom_av1_lavish_tpu.common.loopfilter import \
        pick_filter_level_from_q

    group = frames[1:]
    L = len(group)
    qs = [QINDEX] * (L - 1)
    lfs = [pick_filter_level_from_q(q, frame_is_key=False, bd=8)
           for q in qs]

    def stages():
        imp, maps = tpl_gf_group(group, L - 1)
        arf = temporal_filter(group, L - 1, QINDEX - 20)
        raws, recons = DeviceChainEncoder().encode_chain(
            group[:L - 1], qs, frames[0], group[-1], recon="all",
            lf_levels=lfs)
        return {"tpl": (np.asarray(imp), [np.asarray(m) for m in maps
                                          if m is not None]),
                "temporal_filter": [np.asarray(p) for p in arf],
                "chain": ([{k: np.asarray(v) for k, v in r.items()}
                           for r in raws],
                          [np.asarray(p) for rc in recons for p in rc])}

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k])
                                                for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y)
                                            for x, y in zip(a, b))
        return np.array_equal(np.asarray(a), np.asarray(b))

    gpu = stages()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = stages()
    return {k: same(gpu[k], cpu[k]) for k in gpu}


def phase_gpu_vs_cpu() -> dict:
    import jax

    import bench
    from aom_av1_lavish_tpu.encoder.gop import GopEncoder

    frames = bench.make_frames(n=9, w=WCIF, h=HCIF)
    kw = dict(qindex=QINDEX, gf_length=8, use_tpu=True)

    def encode():
        return GopEncoder(WCIF, HCIF, **kw).encode_sequence(frames)

    gpu = encode()
    _log("CIF encoded on the GPU")
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = encode()
    _log("CIF encoded on the CPU")
    out = {"identical": gpu == cpu,
           "bytes_gpu": sum(map(len, gpu)), "bytes_cpu": sum(map(len, cpu))}
    if gpu != cpu:
        out["first_differing_frame"] = next(
            i for i, (a, b) in enumerate(zip(gpu, cpu)) if a != b)
        out["stage_identical"] = _stage_diffs(frames)
    return out


# ---------------------------------------------------------------------------
# --four: the paths that span four GPUs


def phase_fpmt() -> dict:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import bench
    from aom_av1_lavish_tpu.encoder.gop import GopEncoder

    W, H = W1080, H1080
    frames = bench.make_frames(n=6, w=W, h=H)   # KEY + ARF + 4 P frames
    mesh = Mesh(np.array(jax.devices()[:4]), ("frame",))
    streams = {}
    for name, m in (("mesh4", mesh), ("one_device", None)):
        t0 = time.perf_counter()
        enc = GopEncoder(W, H, qindex=QINDEX, gf_length=len(frames) - 1,
                         use_tpu=True, frame_parallel=True, mesh=m)
        streams[name] = enc.encode_sequence(frames)
        streams[name + "_s"] = time.perf_counter() - t0
    assert streams["mesh4"] == streams["one_device"], \
        "FPMT on 4 GPUs differs from one device"
    shown, _ = _decode_all(streams["mesh4"])
    assert len(shown) == len(frames)
    return {"identical": True, "frames": len(frames),
            "bytes": sum(map(len, streams["mesh4"])),
            "mesh4_s": streams["mesh4_s"],
            "one_device_s": streams["one_device_s"]}


def phase_sharded_lossless() -> dict:
    import bench
    from aom_av1_lavish_tpu.encoder.encoder import (
        LosslessEncoder, make_lossless_frame_header, make_sequence_header)
    from aom_av1_lavish_tpu.parallel.sharding import (
        ShardedLosslessEncoder, make_mesh)

    W, H = W1080, H1080
    frames = bench.make_frames(n=4, w=W, h=H)
    sharded = ShardedLosslessEncoder(W, H, make_mesh(2, 2)).encode_frames(
        frames)
    sh = make_sequence_header(W, H)
    single = [LosslessEncoder(sh, make_lossless_frame_header(
        sh, tile_cols_log2=1)).encode_frame(f) for f in frames]
    assert sharded == single, "sharded lossless differs from one device"
    return {"identical": True, "frames": len(frames),
            "bytes": sum(map(len, sharded))}


ONE_CARD = (("kernels", phase_kernels), ("main_path", phase_main_path),
            ("other_paths", phase_other_paths),
            ("gpu_vs_cpu", phase_gpu_vs_cpu))
FOUR_CARDS = (("fpmt", phase_fpmt),
              ("sharded_lossless", phase_sharded_lossless))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths")
    args = ap.parse_args(argv)

    import jax
    device = check_device(jax.devices(), 4 if args.four else 1)
    sys.path.insert(0, ROOT)
    print(card_line(), flush=True)
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    t0 = time.perf_counter()
    from aom_av1_lavish_tpu.runtime import get_lib
    get_lib()                     # builds the native runtime at first use
    _emit({"phase": "setup", "native_runtime_build_s":
           round(time.perf_counter() - t0, 3), "device": device})

    ok = True
    for name, fn in (FOUR_CARDS if args.four else ONE_CARD):
        ok = run_phase(name, fn) and ok
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    _emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
