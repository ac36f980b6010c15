"""transbmp: decode any file the port reads and write a 32 bpp BMP.

    python -m ffpic_tpu_torch.apps.transbmp FILE [-o OUT] [--device cpu]

Copied from ``ffpic_tpu/apps/transbmp.py`` over the port's registry,
with ``--device`` for the decode: CUDA unless it says ``cpu``.  Without
``-o`` the output is named as the reference's bmpwriter names it,
``"<FILE> (W * H).bmp"``.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="transbmp")
    ap.add_argument("file")
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--device", default=None,
                    help="where to decode: cpu, or CUDA when not given")
    args = ap.parse_args(argv)

    import ffpic_tpu_torch
    try:
        pic = ffpic_tpu_torch.load(args.file, device=args.device)
    except (ValueError, OSError, NotImplementedError) as e:
        print(f"transbmp: {e}", file=sys.stderr)
        return 1
    out = args.out or f"{args.file} ({pic.width} * {pic.height}).bmp"
    data = ffpic_tpu_torch.encode(pic, "BMP", device=args.device)
    with open(out, "wb") as f:
        f.write(data)
    print(f"wrote {out} ({pic.width}x{pic.height})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
