"""aomdec-analog CLI: AV1 IVF/WebM/OBU/Annex-B in, y4m out (optionally
MD5 of frames).

Reference behavior being mirrored: apps/aomdec.c:1053 (main_loop,
--md5 frame checksum mode used by the conformance suites; webmdec/obudec
input autodetection).

    python -m aom_av1_lavish_tpu.apps.dec in.ivf -o out.y4m
    python -m aom_av1_lavish_tpu.apps.dec in.webm --md5
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="avl-dec", description="AV1 decoder")
    p.add_argument("input", help="input .ivf/.webm/.obu file")
    p.add_argument("-o", "--output", default=None, help="output .y4m")
    p.add_argument("--md5", action="store_true",
                   help="print the MD5 of each decoded frame")
    p.add_argument("--annexb", action="store_true",
                   help="input OBU stream uses Annex-B framing")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--summary", action="store_true")
    return p


def _open_input(path: str, annexb: bool):
    """Autodetect container (aomdec file-type sniffing analog)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"DKIF":
        from ..bitstream.ivf import read_ivf
        return (p for p, _ in read_ivf(path))
    if magic == b"\x1a\x45\xdf\xa3":
        from ..utils.webm import read_webm
        return iter(read_webm(path))
    from ..bitstream import obu as OBU
    return OBU.read_annexb(path) if annexb else OBU.read_obu_file(path)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..api import Decoder
    from ..utils.y4m import write_y4m

    dec = Decoder()
    out = []
    t0 = time.perf_counter()
    n = 0
    for payload in _open_input(args.input, args.annexb):
        for planes in dec.decode(payload):
            n += 1
            if args.md5:
                m = hashlib.md5()
                for p in planes:
                    if p is not None:
                        m.update(p.tobytes())
                print(m.hexdigest())
            if args.output:
                out.append(planes)
            if args.limit and n >= args.limit:
                break
        if args.limit and n >= args.limit:
            break
    dt = time.perf_counter() - t0
    if args.output and out:
        h, w = out[0][0].shape
        write_y4m(args.output, out, w, h)
    if args.summary:
        print(f"{n} frames decoded in {dt:.2f}s ({n / max(dt, 1e-9):.2f} "
              f"fps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
