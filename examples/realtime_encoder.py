"""Zero-lag realtime encode, non-RD pickmode (reference:
examples/lossless_encoder.c usage=1 path / nonrd_pickmode.c).

    python examples/realtime_encoder.py in.y4m out.ivf [qindex]
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    from aom_av1_lavish_tpu.encoder.nonrd import encode_realtime_ivf
    from aom_av1_lavish_tpu.utils.y4m import read_y4m
    frames, w, h, _ = read_y4m(sys.argv[1])
    q = int(sys.argv[3]) if len(sys.argv) > 3 else 90
    encode_realtime_ivf(sys.argv[2], frames, w, h, q)
    print(f"realtime-encoded {len(frames)} frames")


if __name__ == "__main__":
    main()
