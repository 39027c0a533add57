"""Pre-bake style packs for a serving fleet (the counterpart of
``tools/bake_packs.py``).

A server reaches full warm speed on the FIRST request for a style only if
the style's pack is already on disk. This tool runs one synthesis per style
through the serving request path (``serve.handle_synthesize``: the same
base64 token, image decode and pack file name), so the packs it writes are
the ones the server would write, ready for ``$OPTEX_PACK_DIR``.

    python -m optimaltextures_tpu_torch.tools.bake_packs \\
        --styles style/*.jpg --pack_dir /packs [--size 512] \\
        [--config pca_bucket=32] [--config hist_mode=chol]

Pass the --config values the servers run with: a pack is keyed by the
config signature, so one baked under another hist_mode, size, etc. is a
cache miss (its statistics differ).
"""

import argparse
import base64
import json
import os
import time


def _parse_config(pairs):
    out = {}
    for p in pairs:
        k, _, v = p.partition("=")
        if not _:
            raise SystemExit(f"--config expects key=value, got {p!r}")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v   # bare strings (e.g. hist_mode=chol)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--styles", nargs="+", required=True,
                    help="style image files to bake")
    ap.add_argument("--pack_dir", required=True,
                    help="where packs land (the servers' $OPTEX_PACK_DIR)")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--config", action="append", default=[],
                    help="extra OptexConfig fields as key=value "
                         "(repeatable); must match the serving config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    os.environ["OPTEX_PACK_DIR"] = args.pack_dir

    from optimaltextures_tpu_torch import core, serve

    cfg = {"size": args.size, **_parse_config(args.config)}
    pool = serve.SynthesizerPool(device=core.resolve_device(args.device))
    before = (set(os.listdir(args.pack_dir)) if os.path.isdir(args.pack_dir)
              else set())
    for path in args.styles:
        with open(path, "rb") as f:
            b64 = base64.b64encode(f.read()).decode()
        t0 = time.time()
        serve.handle_synthesize(pool, {"style_b64": [b64], "config": cfg})
        print(f"{path}: baked in {time.time() - t0:.1f}s", flush=True)
    new = sorted(set(os.listdir(args.pack_dir)) - before)
    print(f"{len(new)} new pack(s) in {args.pack_dir}: {new}", flush=True)


if __name__ == "__main__":
    main()
