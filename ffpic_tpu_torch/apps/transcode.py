"""transcode: decode any file the port reads and encode it with a named
codec.

    python -m ffpic_tpu_torch.apps.transcode FILE -c CODEC -o OUT
        [-q QUALITY] [--device cpu]

Copied from ``ffpic_tpu/apps/transcode.py`` over the port's registry,
with ``--device`` for the decode and the encode: CUDA unless it says
``cpu``.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="transcode")
    ap.add_argument("file")
    ap.add_argument("-c", "--codec", required=True, help="target codec name")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("-q", "--quality", type=int, default=None,
                    help="encoder quality (codec-specific)")
    ap.add_argument("--device", default=None,
                    help="where to decode and encode: cpu, or CUDA when "
                    "not given")
    args = ap.parse_args(argv)

    import ffpic_tpu_torch
    opts = {}
    if args.quality is not None:
        opts["quality"] = args.quality
    try:
        pic = ffpic_tpu_torch.load(args.file, device=args.device)
        data = ffpic_tpu_torch.encode(pic, args.codec, device=args.device,
                                      **opts)
    except (ValueError, OSError, KeyError, NotImplementedError) as e:
        msg = e.args[0] if e.args else e
        print(f"transcode: {msg}", file=sys.stderr)
        return 1
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"wrote {args.out} ({len(data)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
