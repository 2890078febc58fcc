"""aomenc-analog CLI: y4m in, AV1 IVF out.

Reference behavior being mirrored: apps/aomenc.c:2051 (driver loop) +
av1/arg_defs.c (flag registry).  Like aomenc builds its arg table from
arg_defs.c, this CLI generates one ``--<key>`` flag per entry of the
control registry (controls.py) and lowers everything through the public
EncoderConfig/Encoder API, so the CLI surface and the codec-control
surface are the same table.

    python -m aom_av1_lavish_tpu.apps.enc in.y4m -o out.ivf \
        --target-bitrate 400 --gf-length 8
    python -m aom_av1_lavish_tpu.apps.enc in.y4m -o out.ivf --lossless 1
    python -m aom_av1_lavish_tpu.apps.enc in.y4m -o out.ivf \
        --cpu-used 6 --aq-mode 1 --enable-qm 1 --sharpness 3
"""

from __future__ import annotations

import argparse
import sys
import time

from ..controls import BY_KEY

#: registry keys handled by dedicated argparse flags below (aomenc's
#: "global options" vs codec controls split)
_SPECIAL = {"cq-level", "tile-columns", "tile-rows", "cpu-used"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="avl-enc", description="AV1 encoder")
    p.add_argument("input", help="input .y4m file")
    p.add_argument("-o", "--output", required=True, help="output .ivf")
    p.add_argument("--limit", type=int, default=0,
                   help="max frames to encode (0 = all)")
    p.add_argument("--cq-level", type=int, default=60,
                   help="fixed qindex (rc mode Q)")
    p.add_argument("--target-bitrate", type=int, default=0,
                   help="target bitrate in kbit/s (enables CBR)")
    p.add_argument("--end-usage", choices=("q", "cbr", "vbr"), default=None)
    p.add_argument("--kf-max-dist", type=int, default=120)
    p.add_argument("--gf-length", type=int, default=8)
    p.add_argument("--sframe-dist", type=int, default=0,
                   help="SWITCH_FRAME cadence (0 = off)")
    p.add_argument("--no-arf", action="store_true")
    p.add_argument("--tile-columns", type=int, default=0,
                   help="log2 tile columns")
    p.add_argument("--tile-rows", type=int, default=0,
                   help="log2 tile rows")
    p.add_argument("--cpu-used", type=int, default=None,
                   help="speed preset 0 (best) .. 9 (fastest)")
    p.add_argument("--tpu", action="store_true",
                   help="use the batched device encode paths")
    p.add_argument("--fps", default=None, help="override fps as N/D")
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument("--usage", choices=("good", "realtime", "allintra"),
                   default="good")
    p.add_argument("--passes", type=int, choices=(1, 2, 3), default=1)
    p.add_argument("--svc-temporal-layers", type=int, default=1)
    p.add_argument("--film-grain", type=int, default=0,
                   help="estimate + signal film grain "
                        "(alias of --film-grain-test 1)")
    p.add_argument("--superres-denom", type=int, default=8,
                   help="9..16: encode at w*8/denom, signal upscale")
    # one flag per control-registry entry (arg_defs.c analog); values
    # are parsed/range-checked by the registry itself
    grp = p.add_argument_group(
        "codec controls", "AV1E_SET_* control registry (controls.py); "
        "bool controls take 0/1")
    for key, ctl in sorted(BY_KEY.items()):
        if key in _SPECIAL:
            continue
        grp.add_argument("--" + key, default=None, metavar="V",
                         dest="ctl_" + key.replace("-", "_"),
                         help=ctl.help or ctl.name)
    return p


def _report(args, frames, fps, t0) -> int:
    import os
    dt = time.perf_counter() - t0
    if not args.quiet:
        total = os.path.getsize(args.output)
        kbps = total * 8 * (fps[0] / fps[1]) / max(len(frames), 1) / 1000
        print(f"{len(frames)} frames, {total} bytes ({kbps:.1f} kbit/s), "
              f"{len(frames) / dt:.2f} fps", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..api import (USAGE_ALL_INTRA, USAGE_GOOD_QUALITY,
                       USAGE_REALTIME, Encoder, EncoderConfig)
    from ..bitstream.ivf import write_ivf
    from ..controls import apply_control
    from ..encoder.ratectrl import MODE_CBR, MODE_Q, MODE_VBR
    from ..utils.y4m import read_y4m

    frames, width, height, sub = read_y4m(args.input)
    if args.limit:
        frames = frames[:args.limit]
    fps = (30, 1)
    if args.fps:
        n, d = args.fps.split("/")
        fps = (int(n), int(d))

    # multi-pass routes drive the stats pipeline directly
    if args.passes == 2:
        from ..encoder.gop import encode_twopass_ivf
        t0 = time.perf_counter()
        encode_twopass_ivf(args.output, frames, width, height, fps=fps,
                           qindex=args.cq_level,
                           kf_interval=args.kf_max_dist,
                           gf_length=args.gf_length)
        return _report(args, frames, fps, t0)
    if args.passes == 3:
        from ..encoder.thirdpass import encode_threepass_ivf
        t0 = time.perf_counter()
        encode_threepass_ivf(args.output, frames, width, height, fps=fps,
                             kf_interval=args.kf_max_dist,
                             gf_length=args.gf_length)
        return _report(args, frames, fps, t0)

    mode = MODE_Q
    if args.end_usage == "cbr" or (args.end_usage is None
                                   and args.target_bitrate):
        mode = MODE_CBR
    elif args.end_usage == "vbr":
        mode = MODE_VBR
    usage = {"good": USAGE_GOOD_QUALITY, "realtime": USAGE_REALTIME,
             "allintra": USAGE_ALL_INTRA}[args.usage]
    cfg = EncoderConfig(
        width=width, height=height, fps=fps[0] / fps[1], usage=usage,
        rc_mode=mode, target_bps=args.target_bitrate * 1000,
        qindex=args.cq_level, kf_interval=args.kf_max_dist,
        gf_length=args.gf_length, use_arf=not args.no_arf,
        sframe_dist=args.sframe_dist,
        tile_cols_log2=args.tile_columns, tile_rows_log2=args.tile_rows,
        use_tpu=args.tpu, cpu_used=args.cpu_used, subsampling=sub)
    if args.svc_temporal_layers > 1:
        cfg.temporal_layers = args.svc_temporal_layers
    if args.film_grain:
        cfg.film_grain_test_vector = 1
    if args.superres_denom != 8:
        cfg.enable_superres = True
        cfg.superres_denom = args.superres_denom
    for key in BY_KEY:
        if key in _SPECIAL:
            continue
        val = getattr(args, "ctl_" + key.replace("-", "_"), None)
        if val is not None:
            apply_control(cfg, key, val)

    enc = Encoder(cfg)
    t0 = time.perf_counter()
    for f in frames:
        enc.encode(f)
    payloads = enc.flush()
    dt = time.perf_counter() - t0
    write_ivf(args.output, [(p, i) for i, p in enumerate(payloads)],
              width, height, fps[0], fps[1])
    if not args.quiet:
        total = sum(len(p) for p in payloads)
        kbps = total * 8 * (fps[0] / fps[1]) / max(len(payloads), 1) / 1000
        print(f"{len(payloads)} frames, {total} bytes "
              f"({kbps:.1f} kbit/s), {len(payloads) / dt:.2f} fps",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
