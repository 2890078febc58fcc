"""Two-pass VBR encode (reference: examples/twopass_encoder.c).

    python examples/twopass_encoder.py in.y4m out.ivf [kbps]
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    from aom_av1_lavish_tpu.encoder.gop import encode_twopass_ivf
    from aom_av1_lavish_tpu.encoder.ratectrl import (MODE_CBR,
                                                     RateControlConfig)
    from aom_av1_lavish_tpu.utils.y4m import read_y4m
    frames, w, h, _ = read_y4m(sys.argv[1])
    kbps = int(sys.argv[3]) if len(sys.argv) > 3 else 400
    cfg = RateControlConfig(target_bps=kbps * 1000,
                            fps=30.0, mode=MODE_CBR)
    encode_twopass_ivf(sys.argv[2], frames, w, h, rc_cfg=cfg)
    print(f"two-pass encoded {len(frames)} frames @ {kbps} kbit/s")


if __name__ == "__main__":
    main()
