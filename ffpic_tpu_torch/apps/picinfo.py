"""picinfo: probe files, print their structured metadata, and decode
them unless told not to.

    python -m ffpic_tpu_torch.apps.picinfo [-s] [--device cpu] FILE...

Copied from ``ffpic_tpu/apps/picinfo.py`` over the port's registry,
with ``--device`` for the decode: CUDA unless it says ``cpu``.  ``-s`` /
``--skip_decode`` parses headers only, which needs no CUDA.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="picinfo")
    ap.add_argument("files", nargs="+")
    ap.add_argument("-s", "--skip_decode", action="store_true",
                    help="parse headers only, no pixel decode")
    ap.add_argument("--device", default=None,
                    help="where to decode: cpu, or CUDA when not given")
    args = ap.parse_args(argv)

    import ffpic_tpu_torch
    # a header-only parse needs no device
    device = None if args.skip_decode else args.device
    rc = 0
    for path in args.files:
        try:
            codec = ffpic_tpu_torch.probe(path)
            pic = ffpic_tpu_torch.load(path, skip_decode=args.skip_decode,
                                       device=device)
        except (ValueError, OSError, NotImplementedError) as e:
            print(f"{path}: {e}", file=sys.stderr)
            rc = 1
            continue
        print(f"{path}: codec {codec.name}")
        print(ffpic_tpu_torch.info(pic))
        if pic.frames:
            print(f"\t+{len(pic.frames)} extra frame(s)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
