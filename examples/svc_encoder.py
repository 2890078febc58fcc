"""Temporal-SVC encode (reference: examples/svc_encoder_rtc.c).

    python examples/svc_encoder.py in.y4m out.ivf [layers]
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    from aom_av1_lavish_tpu.encoder.svc import encode_svc_ivf
    from aom_av1_lavish_tpu.utils.y4m import read_y4m
    frames, w, h, _ = read_y4m(sys.argv[1])
    layers = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    encode_svc_ivf(sys.argv[2], frames, w, h,
                   temporal_layers=layers)
    print(f"SVC encoded {len(frames)} frames, {layers} temporal layers")


if __name__ == "__main__":
    main()
