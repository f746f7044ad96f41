#!/usr/bin/env python3
"""A/B of the port's flash-attention kernels on one CUDA card.

Runs each of ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` whose
build differs between two versions of ``elasticdl_tpu_torch/ops/csrc``
(its source or a shared header) through the package's own wrappers,
once per version, on the same seeded inputs: this checkout's sources and
another version, each built by ``ops/build.py`` as usual. The other
version is either another checkout's sources (``--other-csrc``, for
example a parent commit's, unpacked with ``git archive``) or this
checkout's with the bf16 kernels' owned-tile rows changed
(``--tile-rows``, constants of ``TILE_CONSTANTS``). Prints the card and
the kernels compared, then one JSON line per case:
whether the two agree bitwise, their relative L2 distance, and each
side's time over 50 launches, taken in turns (other, this, this, other);
then each side's ptxas reports. Run from the root of a checkout:

    git archive HEAD~1 elasticdl_tpu_torch/ops/csrc | tar -x -C parent
    python3 scripts/torch_flash_ab.py \\
        --other-csrc parent/elasticdl_tpu_torch/ops/csrc
    python3 scripts/torch_flash_ab.py --tile-rows kFwdRows=64
"""

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [  # (B, H, D, L): the training and serving shapes, a D = 96 shape
    (16, 12, 64, 1024),
    (8, 12, 64, 1024),
    (4, 16, 96, 1024),
]
LAUNCHES = 50
KERNELS = {  # name -> its source
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd_dq": "flash_bwd.cu",
    "flash_bwd_dkv": "flash_bwd.cu",
}
TILE_CONSTANTS = {  # the bf16 kernels' owned rows, by constant -> source
    "kFwdRows": "flash_fwd.cu",
    "kDqRows": "flash_bwd.cu",
    "kDkvRows": "flash_bwd.cu",
}


def tile_setting(text):
    """``NAME=ROWS`` -> (NAME, ROWS), NAME one of TILE_CONSTANTS."""
    name, _, rows = text.partition("=")
    if name not in TILE_CONSTANTS or not rows.isdigit():
        raise argparse.ArgumentTypeError(
            "expected NAME=ROWS with NAME in %s" % sorted(TILE_CONSTANTS)
        )
    return name, int(rows)


def tile_rows_copy(build, settings, into):
    """A copy of this checkout's csrc/ under ``into`` with each
    ``(constant, rows)`` of ``settings`` set."""
    csrc = os.path.join(into, "csrc")
    shutil.copytree(build.CSRC_DIR, csrc)
    for name, n in settings:
        path = os.path.join(csrc, TILE_CONSTANTS[name])
        with open(path) as f:
            src = f.read()
        src, hits = re.subn(r"(constexpr int %s = )\d+;" % name,
                            r"\g<1>%d;" % n, src)
        if hits != 1:
            raise RuntimeError("%s has no single %s" % (path, name))
        with open(path, "w") as f:
            f.write(src)
    return csrc


@contextlib.contextmanager
def built_from(build, csrc, loaded):
    """Inside, the package's kernels load from ``csrc``'s libraries,
    cached in ``loaded``."""
    saved = build.CSRC_DIR, build._loaded
    build.CSRC_DIR, build._loaded = csrc, loaded
    try:
        yield
    finally:
        build.CSRC_DIR, build._loaded = saved


def time_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    other = parser.add_mutually_exclusive_group(required=True)
    other.add_argument("--other-csrc",
                       help="another version of elasticdl_tpu_torch/ops/csrc")
    other.add_argument("--tile-rows", type=tile_setting, nargs="+",
                       metavar="NAME=ROWS",
                       help="this checkout's sources with these owned rows")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from elasticdl_tpu_torch.ops import build
    from elasticdl_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        csrc = {"this": build.CSRC_DIR, "other": (
            os.path.abspath(args.other_csrc) if args.other_csrc
            else tile_rows_copy(build, args.tile_rows, tmp)
        )}
        loaded = {"this": {}, "other": {}}
        kernels = []
        for kernel, source in KERNELS.items():
            libraries = set()
            for side in csrc:
                with built_from(build, csrc[side], loaded[side]):
                    libraries.add(build._library_path(source))
            if len(libraries) > 1:
                kernels.append(kernel)
        print("kernels whose build differs: %s" % kernels, flush=True)

        def run(side, kernel, inputs):
            with built_from(build, csrc[side], loaded[side]):
                if kernel == "flash_fwd":
                    return fa._flash_fwd_kernel(*inputs[:3], inputs[-1])
                if kernel == "flash_bwd_dq":
                    return (fa.flash_bwd_dq(*inputs),)
                return fa.flash_bwd_dkv(*inputs)

        for dtype in ("float32", "bfloat16"):
            for b, h, d, l in CASES:
                for causal in (False, True):
                    gen = torch.Generator(device="cuda").manual_seed(5)
                    q, k, v, g = (
                        torch.randn((b, l, h, d), generator=gen,
                                    device="cuda").to(getattr(torch, dtype))
                        for _ in range(4)
                    )
                    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
                    delta = fa.flash_delta(out, g)
                    inputs = (q, k, v, g, lse, delta, causal)
                    for kernel in kernels:
                        got = {s: run(s, kernel, inputs)
                               for s in ("other", "this")}
                        torch.cuda.synchronize()
                        ms = {"other": [], "this": []}
                        for side in ("other", "this", "this", "other"):
                            ms[side].append(time_ms(
                                torch, lambda: run(side, kernel, inputs),
                                LAUNCHES,
                            ))
                        pairs = list(zip(got["other"], got["this"]))
                        print(json.dumps({
                            "kernel": kernel,
                            "shape": [b, l, h, d],
                            "dtype": dtype,
                            "causal": causal,
                            "bitwise": all(torch.equal(x, y)
                                           for x, y in pairs),
                            "rel_l2": max(
                                float(torch.linalg.vector_norm(
                                    y.float() - x.float())
                                    / torch.linalg.vector_norm(x.float()))
                                for x, y in pairs
                            ),
                            "ms": ms,
                            "card": card,
                        }, sort_keys=True), flush=True)
        for side in ("other", "this"):
            with built_from(build, csrc[side], loaded[side]):
                for source in sorted({KERNELS[k] for k in kernels}):
                    print("ptxas report for %s (%s):" % (source, side))
                    print(build.ptxas_report(source).strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
