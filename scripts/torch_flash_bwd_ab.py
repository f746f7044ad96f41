#!/usr/bin/env python3
"""A/B of the port's flash-attention backward kernels on one CUDA card.

Runs ``flash_bwd_dq`` and ``flash_bwd_dkv`` through the package's own
wrappers twice on the same seeded inputs: once built from this
checkout's ``elasticdl_tpu_torch/ops/csrc`` and once from another
version of that directory, each built by ``ops/build.py`` as usual. The
other version is either another checkout's sources (``--other-csrc``,
for example a parent commit's, unpacked with ``git archive``) or this
checkout's with the bf16 kernels' owned-tile rows changed
(``--tile-rows DQ DKV``). Prints the card, then one JSON line per case:
whether the two agree bitwise, their relative L2 distance, and each
side's time over 50 launches, taken in turns (other, this, this,
other); then each side's ptxas report. Run from the root of a checkout:

    git archive HEAD~1 elasticdl_tpu_torch/ops/csrc | tar -x -C parent
    python3 scripts/torch_flash_bwd_ab.py \\
        --other-csrc parent/elasticdl_tpu_torch/ops/csrc
    python3 scripts/torch_flash_bwd_ab.py --tile-rows 64 128
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
CASES = [  # (B, H, D, L): the training shape and a D = 96 shape
    (16, 12, 64, 1024),
    (4, 16, 96, 1024),
]
LAUNCHES = 50
TILE_CONSTANTS = ("kDqRows", "kDkvRows")  # flash_bwd.cu, bf16 owned rows


def tile_rows_copy(build, rows, into):
    """A copy of this checkout's csrc/ under ``into`` whose flash_bwd.cu
    owns ``rows`` = (dq, dkv) rows per bf16 block."""
    csrc = os.path.join(into, "csrc")
    shutil.copytree(build.CSRC_DIR, csrc)
    path = os.path.join(csrc, "flash_bwd.cu")
    with open(path) as f:
        src = f.read()
    for name, n in zip(TILE_CONSTANTS, rows):
        src, hits = re.subn(r"(constexpr int %s = )\d+;" % name,
                            r"\g<1>%d;" % n, src)
        if hits != 1:
            raise RuntimeError("flash_bwd.cu has no single %s" % name)
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
    other.add_argument("--tile-rows", type=int, nargs=2,
                       metavar=("DQ", "DKV"),
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

        def run(side, kernel, inputs):
            with built_from(build, csrc[side], loaded[side]):
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
                    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
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
                print("ptxas report (%s):" % side)
                print(build.ptxas_report("flash_bwd.cu").strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
