#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``elasticdl_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. device  — the card, its power limit, the CUDA toolkit.
2. build   — every kernel under ``elasticdl_tpu_torch/ops/csrc`` built
   from source with nvcc for sm_90a, all at once (the ptxas report kept
   beside each library is printed; a spill in a bf16 kernel, or a report
   that does not list them, fails).
3. kernels — each kernel against its plain PyTorch version on the card,
   at the listed shapes, with times, the bound and the library yardstick:
   flash_fwd, then flash_bwd_dq and flash_bwd_dkv (with and without an
   lse cotangent), each also at a ragged length and at Lq != Lk, two
   launches of each case bitwise equal; then a long-sequence check that
   the backward allocates no (L, L) buffer. Each output and gradient is
   held elementwise and by its relative L2 distance, and each case shows
   that a planted fault (a mask one tile off, a 10 % scale error) fails.
   Forward times are taken twice: CUDA events around 50 calls of the
   autograd wrapper, and the device time per call from torch.profiler
   (the kernel's own, even where the host's enqueue time per call nears
   it), both for SDPA too.
4. slice   — the 110M transformer LM (bf16, random weights from a seed)
   exported, then served through the scorer's entry points
   (build_scorer -> ScorerServicer -> MicroBatcher -> Scorer) on
   concurrent 1024-token requests. Replies are checked against solo
   scoring and against the model with attention swapped for the plain
   version; kernel launches are counted over the served requests alone
   (12 forward, 0 backward per forward). Then a torch.profiler breakdown
   of one batched forward.
5. train   — the same model trained through AllReduceTrainer.train_step
   (AdamW, 16 x 1024-token batches): finite losses, a finite, nonzero
   gradient for every parameter, 12 launches of each kernel per step;
   gradients against the plain-attention model and against
   plain_flash_bwd on the same forward; one rematerialized step; step
   time, tokens/s, MFU, peak memory and a profiler breakdown of one step.
6. job     — bench.py's fused ResNet-50 step (b128, 224x224, bf16, SGD
   with momentum, data resident on the card): step time, examples/s,
   MFU, peak memory. Then the single-process ALLREDUCE job through the
   port's command line in this process (master -> task dispatcher ->
   AllReduceWorker -> RecordIO reader) on 896 synthetic ImageNet-shaped
   records from the seed: the dispatcher finishes at version 14, every
   loss and parameter finite, every batch statistic moved, the newest
   checkpoint restores bitwise into a fresh trainer, the export manifest
   exists; the bf16 model held against the f32 one on one batch; the
   job's examples/s over its steps after the first and its ratio to the
   fused step; a torch.profiler breakdown of a few steps of a second run
   (idle share, top device ops, the largest device-idle gaps). ResNet-50
   launches none of the flash kernels: the kernels line says so
   (``launches_by_path.job`` = 0).
7. eval    — the evaluation plane on the same model and records, through
   the port's command line: the job again with 256 validation records
   from the seed and ``--evaluation_steps 4`` (three rounds, pinned to
   versions 4, 8 and 12, each over all 256 records and within 2/256 of
   a direct forward of its checkpoint restored into a fresh model; the
   job's examples/s against the job phase's, and the rounds' seconds);
   ``evaluate`` on the same images labelled from the final checkpoint's
   own predictions, half of them off by one, from the checkpoint (0.5
   within 2/256) and from the export (the direct fresh-statistics
   forward's accuracy); ``predict`` with a capturing processor (every
   record once, within 1e-2 relative L2 of the direct forward). No flash
   kernel launches (``launches_by_path.eval`` = 0).
8. summary — the kernels line, the card line, then the result line.

Without a CUDA card, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, dense
# bf16 tensor-core rate, f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

KERNEL_SHAPES = [  # (B, H, D, L)
    (1, 12, 64, 1024),
    (8, 12, 64, 1024),
    (4, 16, 96, 1024),
    (2, 12, 64, 2048),
]
TRAIN_SHAPE = (16, 12, 64, 1024)  # the training slice's attention
# untimed cases of every kernel (B, H, D, Lq, Lk): a length below one tile
# of the kernels' owned rows (zero-filled copies, store masks, a tile that
# straddles the end) and Lq != Lk (the causal start and stop of the
# loops, at absolute positions)
EXTRA_CASES = [
    (2, 12, 64, 96, 96),
    (2, 12, 64, 512, 1024),
]
TIMED_LAUNCHES = 50  # kernels and SDPA, per timing
TOL = {  # dtype -> (rtol, atol) against the plain version in float32
    "float32": (2e-4, 2e-5),
    "bfloat16": (0.0, 2e-2),
}
# gradients: the reference's own tolerances (tests/test_flash_attention.py)
BWD_TOL = {"float32": (3e-4, 3e-4), "bfloat16": (0.1, 0.1)}
# Per tensor (out, dq, dk, dv), relative L2 distance from the plain
# version in float32. At L >= 1024 an output or a gradient of random
# inputs is ~0.05 per element, no larger than the elementwise limits
# above, so this is the gate that sees a wrong tile; each case also
# shows that a planted fault (a mask one tile off, a 10 % scale error)
# lies beyond it. PERF.md section 6 has the readings.
REL_L2 = {"float32": 1e-5, "bfloat16": 2e-2}
FAULT_TILE = 64  # the kernels' tile: the planted mask fault is one tile off
MEM_SHAPE = (1, 12, 64, 8192)  # the backward's no-(L, L) check, bf16

# The repo's headline transformer_lm width (bench.py's 110M config).
SLICE_CFG = dict(
    vocab_size=32768, num_layers=12, num_heads=12, head_dim=64,
    embed_dim=768, mlp_dim=3072, dtype="bfloat16",
)
MODEL_DEF = "transformer_lm.transformer_lm.custom_model"
SEQ_LEN = 1024  # pick_causal_attention takes the kernel from L = 1024
N_REQUESTS = 32
MAX_BATCH = 8
REPLY_ATOL = 0.1  # bf16 logits: batched vs solo, kernel vs plain attention
SEED = 0
DEVICE = "cuda"

# training (bench.py's headline step: b16 x L1024, AdamW at 3e-3)
TRAIN_BATCH = 16
TRAIN_STEPS = 10  # timed, after one warm-up step
LR = 3e-3
GRAD_CHECK_BATCH = 4  # kernel vs plain-attention gradients
GRAD_REL_L2 = 5e-2  # per tensor, bf16 compute, from the seeded init
# (PERF.md says why; after training on random tokens the q/k gradients
# shrink until the reference's bf16 delta dominates them: reported only)
# Per tensor, the kernels against plain_flash_bwd's own formula (same
# forward, same delta, float32) from the seeded init and from the
# trained weights: what the backward kernels alone add (read 0.011 and
# 0.0046 on an H100, PERF.md section 6).
FORMULA_REL_L2 = 2e-2
REMAT_LOSS_RTOL = 1e-3

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "flash_fwd": (
        "elasticdl_tpu_torch/ops/csrc/flash_fwd.cu",
        "elasticdl_tpu/ops/flash_attention.py:39",
    ),
    "flash_bwd_dq": (
        "elasticdl_tpu_torch/ops/csrc/flash_bwd.cu",
        "elasticdl_tpu/ops/flash_attention.py:128",
    ),
    "flash_bwd_dkv": (
        "elasticdl_tpu_torch/ops/csrc/flash_bwd.cu",
        "elasticdl_tpu/ops/flash_attention.py:175",
    ),
}


def emit(obj):
    print(json.dumps(obj, sort_keys=True), flush=True)


class PhaseError(RuntimeError):
    pass


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise PhaseError("%s failed: %s" % (cmd[0], proc.stderr[-2000:]))
    return proc.stdout.strip()


def phase_device(torch):
    smi = _run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ]
    ).splitlines()
    from elasticdl_tpu_torch.ops.build import find_nvcc

    nvcc = _run([find_nvcc(), "--version"]).splitlines()
    emit(
        {
            "phase": "device",
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi[0] if smi else "",
            "torch": torch.__version__,
            "torch_cuda": torch.version.cuda,
            "nvcc": next((l for l in nvcc if "release" in l), nvcc[-1]),
        }
    )
    return smi[0] if smi else ""


def ptxas_summary(log):
    """{kernel symbol: {"registers", "spill_bytes"}} from a ``-Xptxas
    -v`` report."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(
            r"(?:Compiling entry function '|Function properties for )"
            r"'?([\w$]+)", line
        )
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


# the bf16 kernels the spill gate holds, by source
BF16_KERNELS = {
    "flash_fwd.cu": ("flash_fwd_bf16",),
    "flash_bwd.cu": ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"),
}


def phase_build():
    """Every source built at once; fails on a spill in a bf16 kernel,
    read from the ptxas report kept beside each library (so a cached
    build is gated as a fresh one is)."""
    from elasticdl_tpu_torch.ops import build

    t0 = time.perf_counter()
    built = build.build_all()
    reports = {s: build.ptxas_report(s) for s in built}
    summary = {s: ptxas_summary(log) for s, log in reports.items()}
    emit(
        {
            "phase": "build",
            "seconds": time.perf_counter() - t0,
            "libraries": {s: os.path.basename(p) for s, p in built.items()},
            "ptxas": summary,
        }
    )
    for source, log in sorted(reports.items()):
        print("ptxas report for %s:" % source)
        print(log.strip())
    spills = {}
    for source, kernels in BF16_KERNELS.items():
        bf16 = {
            sym: info for sym, info in summary[source].items()
            if "bf16" in sym
        }
        for kernel in kernels:
            if not any(kernel in sym and "spill_bytes" in info
                       for sym, info in bf16.items()):
                raise PhaseError(
                    "the ptxas report of %s gives no spill count for %s: %s"
                    % (source, kernel, sorted(bf16))
                )
        spills.update({sym: i["spill_bytes"] for sym, i in bf16.items()
                       if i.get("spill_bytes")})
    if spills:
        raise PhaseError("bf16 kernels spill: %s" % spills)


def time_ms(torch, fn, iters, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA
    events around the whole run, after a warm-up)."""
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


def _device_rows(prof):
    """[(device us, kernel name, calls)] of a torch.profiler run, largest
    first: device-side events only (a CPU op's device total repeats the
    time of the kernels it launched)."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    return rows


def per_call_ms(torch, fn, iters):
    """(device ms, host ms) per call of ``fn()``: the device time of the
    kernels it launched, summed by torch.profiler over ``iters`` calls,
    and the host's time to issue one call (no sync, outside the
    profiler); both after a warm-up. None for the device time when the
    profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    device_ms = sum(r[0] for r in rows) / 1e3 / iters if rows else None
    return device_ms, host_ms


def _pairs(lq, lk, causal):
    """Visible (query, key) pairs of one head."""
    if causal:
        return sum(min(i + 1, lk) for i in range(lq))
    return lq * lk


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def flash_bound(b, h, d, lq, lk, dtype, causal):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (q, k, v read once, out and lse written once) over HBM
    bandwidth and its two matrix products over the dtype's peak rate.
    Causal work counts only the visible (query, key) pairs."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * lq * h * d + 2 * b * lk * h * d) * elem + b * h * lq * 4
    ops = 4.0 * b * h * d * _pairs(lq, lk, causal)
    return _bound(nbytes, ops, dtype)


def bwd_bound(kernel, b, h, d, lq, lk, dtype, causal):
    """(bound_ms, bound_by) of one backward kernel. flash_bwd_dq reads q,
    k, v, dO and writes dq, and does three products (S, dP, dQ: 6 D
    operations per visible pair); flash_bwd_dkv reads q, k, v, dO and
    writes dk, dv, and does four (S, dP, dV, dK: 8 D). Both read lse and
    delta (float32, one per query row)."""
    elem = 2 if dtype == "bfloat16" else 4
    q_side, k_side = b * lq * h * d, b * lk * h * d
    if kernel == "flash_bwd_dq":
        tensors, per_pair = 3 * q_side + 2 * k_side, 6
    else:
        tensors, per_pair = 2 * q_side + 4 * k_side, 8
    nbytes = tensors * elem + 2 * b * h * lq * 4
    ops = float(per_pair) * b * h * d * _pairs(lq, lk, causal)
    return _bound(nbytes, ops, dtype)


def _rel_l2(torch, got, want):
    return float(
        torch.linalg.vector_norm(got.float() - want.float())
        / torch.linalg.vector_norm(want.float()).clamp_min(1e-30)
    )


def _fault_mask(torch, lq, lk, causal, device):
    """(Lq, Lk) visible pairs with one key tile wrong, as a kernel whose
    tile loop is off by one would see them: under causal masking, keys up
    to one tile past the diagonal; otherwise the last key tile dropped."""
    q_pos = torch.arange(lq, device=device)[:, None]
    k_pos = torch.arange(lk, device=device)[None, :]
    if causal:
        return k_pos <= q_pos + FAULT_TILE
    return (k_pos < lk - FAULT_TILE).expand(lq, lk)


def _masked_attention(torch, q, k, v, visible):
    """Softmax attention over ``visible`` pairs, in float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = (s * q.shape[-1] ** -0.5).masked_fill(~visible, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v.float())


def _masked_bwd(torch, q, k, v, out, lse, g, g_lse, visible):
    """``plain_flash_bwd``'s formula over ``visible`` pairs, with the lse
    and delta of the correct forward -> (dq, dk, dv) in float32."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    scale = q.shape[-1] ** -0.5
    delta = fa.flash_delta(out, g, g_lse)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~visible, 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vf) - delta[..., None])
    return (
        torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale,
        torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale,
        torch.einsum("bhqk,bqhd->bkhd", p, gf),
    )


def check_flash_case(torch, b, h, d, lq, lk, dtype, causal, seed, timed):
    """The forward kernel against ``plain_flash_with_lse`` in float32 from
    the same inputs; a second launch must give bitwise the same out and
    lse. With ``timed``, times the kernel, the plain version and SDPA."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    tdtype = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = (
        torch.randn(
            (b, length, h, d), generator=gen, device=DEVICE,
            dtype=torch.float32,
        ).to(tdtype)
        for length in (lq, lk, lk)
    )
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    again = fa.flash_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    bitwise = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    del again
    ref_out, ref_lse = fa.plain_flash_with_lse(
        q.float(), k.float(), v.float(), causal
    )
    rtol, atol = TOL[dtype]
    err_out = (out.float() - ref_out).abs()
    err_lse = (lse - ref_lse).abs()
    rel = _rel_l2(torch, out, ref_out)
    faults = {
        "out*0.9": _rel_l2(torch, 0.9 * out.float(), ref_out),
        "mask one tile off": _rel_l2(
            torch,
            _masked_attention(
                torch, q, k, v, _fault_mask(torch, lq, lk, causal, q.device)
            ),
            ref_out,
        ),
    }
    limit = REL_L2[dtype]
    ok = bool(
        bitwise
        and torch.isfinite(out).all()
        and (err_out <= atol + rtol * ref_out.abs()).all()
        and (err_lse <= atol + rtol * ref_lse.abs()).all()
        and rel <= limit
    )
    bound_ms, bound_by = flash_bound(b, h, d, lq, lk, dtype, causal)
    rec = {
        "phase": "kernels",
        "kernel": "flash_fwd",
        "shape": [b, lq, h, d],
        "lk": lk,
        "dtype": dtype,
        "causal": causal,
        "bitwise_repeat": bitwise,
        "max_abs_err": float(err_out.max()),
        "max_abs_err_lse": float(err_lse.max()),
        "rtol": rtol,
        "atol": atol,
        "rel_l2": rel,
        "rel_l2_limit": limit,
        "fault_rel_l2": faults,
        "ok": ok,
        "bound_ms": bound_ms,
        "bound_us": bound_ms * 1e3,
        "bound_by": bound_by,
    }
    if timed:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def kernel():
            return fa.flash_attention_with_lse(q, k, v, causal)

        def library():
            return sdpa(qt, kt, vt, is_causal=causal)

        rec.update(
            kernel_ms=time_ms(torch, kernel, TIMED_LAUNCHES),
            plain_ms=time_ms(
                torch, lambda: fa.plain_flash_with_lse(q, k, v, causal), 5, 1
            ),
            library_ms=time_ms(torch, library, TIMED_LAUNCHES),
        )
        rec["kernel_device_ms"], rec["kernel_host_ms"] = per_call_ms(
            torch, kernel, TIMED_LAUNCHES
        )
        rec["library_device_ms"], rec["library_host_ms"] = per_call_ms(
            torch, library, TIMED_LAUNCHES
        )
    emit(rec)
    if not ok:
        raise PhaseError(
            "flash_fwd disagrees with its plain version (or with its own "
            "second launch: bitwise %s) at %s" % (bitwise, rec)
        )
    if min(faults.values()) <= limit:
        raise PhaseError(
            "the flash_fwd check cannot see a planted fault at %s" % rec
        )
    return rec


def phase_kernels(torch):
    """Every (shape, dtype, causal) case of the forward kernel, timed
    where the shape is square; returns the records."""
    records = []
    seed = 0
    cases = [(b, h, d, l, l) for b, h, d, l in KERNEL_SHAPES + [TRAIN_SHAPE]]
    for b, h, d, lq, lk in cases + EXTRA_CASES:
        for dtype in ("float32", "bfloat16"):
            for causal in (False, True):
                seed += 1
                records.append(
                    check_flash_case(
                        torch, b, h, d, lq, lk, dtype, causal, seed,
                        timed=(b, h, d, lq, lk) in cases,
                    )
                )
    return records


def _bwd_inputs(torch, b, h, d, lq, lk, dtype, with_lse, seed):
    """Seeded q, k, v, dO (and an lse cotangent) on the card."""
    tdtype = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(length):
        return torch.randn(
            (b, length, h, d), generator=gen, device=DEVICE,
            dtype=torch.float32,
        ).to(tdtype)

    q, k, v, g = randn(lq), randn(lk), randn(lk), randn(lq)
    g_lse = (
        torch.randn((b, h, lq), generator=gen, device=DEVICE)
        if with_lse
        else None
    )
    return q, k, v, g, g_lse


def check_bwd_case(torch, b, h, d, lq, lk, dtype, causal, with_lse, seed,
                   timed):
    """Both backward kernels against ``plain_flash_bwd`` in float32 from
    the same inputs (the forward kernel's out and lse), with or without
    an lse cotangent; a second launch of each must give bitwise the same
    gradients. With ``timed``, times each kernel, the plain version and
    SDPA's backward. Returns one record per kernel."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    q, k, v, g, g_lse = _bwd_inputs(
        torch, b, h, d, lq, lk, dtype, with_lse, seed
    )
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    delta = fa.flash_delta(out, g, g_lse)
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    again = (fa.flash_bwd_dq(q, k, v, g, lse, delta, causal),
             *fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal))
    torch.cuda.synchronize()
    bitwise = all(
        torch.equal(x, y) for x, y in zip((dq, dk, dv), again)
    )
    del again
    want = fa.plain_flash_bwd(
        q.float(), k.float(), v.float(), out.float(), lse, g.float(),
        causal, g_lse,
    )
    rtol, atol = BWD_TOL[dtype]
    limit = REL_L2[dtype]
    planted = _masked_bwd(
        torch, q, k, v, out, lse, g, g_lse,
        _fault_mask(torch, lq, lk, causal, q.device),
    )
    errs, rels, faults = {}, {}, {}
    ok = bitwise
    for name, got, ref, bad in zip(
        ("dq", "dk", "dv"), (dq, dk, dv), want, planted
    ):
        err = (got.float() - ref).abs()
        errs[name] = float(err.max())
        rels[name] = _rel_l2(torch, got, ref)
        faults[name] = {
            name + "*0.9": _rel_l2(torch, 0.9 * got.float(), ref),
            "mask one tile off": _rel_l2(torch, bad, ref),
        }
        ok = ok and bool(
            torch.isfinite(got).all()
            and (err <= atol + rtol * ref.abs()).all()
            and rels[name] <= limit
        )
    del planted
    timed_ms = {}
    if timed:
        timed_ms["flash_bwd_dq"] = time_ms(
            torch, lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, causal),
            TIMED_LAUNCHES,
        )
        timed_ms["flash_bwd_dkv"] = time_ms(
            torch, lambda: fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal),
            TIMED_LAUNCHES,
        )
        plain_ms = time_ms(
            torch,
            lambda: fa.plain_flash_bwd(q, k, v, out, lse, g, causal),
            3, 1,
        )
        sdpa_bwd = _sdpa_bwd_ms(torch, q, k, v, g, causal)
    records = []
    for kernel, names in (("flash_bwd_dq", ("dq",)),
                          ("flash_bwd_dkv", ("dk", "dv"))):
        bound_ms, bound_by = bwd_bound(kernel, b, h, d, lq, lk, dtype, causal)
        rec = {
            "phase": "kernels",
            "kernel": kernel,
            "shape": [b, lq, h, d],
            "lk": lk,
            "dtype": dtype,
            "causal": causal,
            "g_lse": with_lse,
            "bitwise_repeat": bitwise,
            "max_abs_err": max(errs[n] for n in names),
            "max_abs_err_by_grad": {n: errs[n] for n in names},
            "rtol": rtol,
            "atol": atol,
            "rel_l2": max(rels[n] for n in names),
            "rel_l2_by_grad": {n: rels[n] for n in names},
            "rel_l2_limit": limit,
            "fault_rel_l2": {n: faults[n] for n in names},
            "ok": ok,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        if timed_ms:
            rec.update(
                kernel_ms=timed_ms[kernel],
                plain_ms=plain_ms,  # both gradients, the whole function
                library_ms=sdpa_bwd,  # SDPA's backward: dq, dk and dv
            )
        emit(rec)
        records.append(rec)
    if not ok:
        raise PhaseError(
            "flash backward disagrees with its plain version (or with its "
            "own second launch: bitwise %s) at %s lk=%d %s causal=%s "
            "g_lse=%s: max abs %s, rel L2 %s" % (
                bitwise, [b, lq, h, d], lk, dtype, causal, with_lse, errs,
                rels,
            )
        )
    unseen = {
        n: f for n, f in faults.items() if min(f.values()) <= limit
    }
    if unseen:
        raise PhaseError(
            "the backward check cannot see a planted fault at %s lk=%d %s "
            "causal=%s: %s (limit %g)" % ([b, lq, h, d], lk, dtype, causal,
                                          unseen, limit)
        )
    return records


def _sdpa_bwd_ms(torch, q, k, v, g, causal):
    """SDPA's backward alone (dq, dk and dv from one retained forward of
    (B, H, L, D) views of the same inputs), per launch."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (
        x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)
    )
    out = sdpa(qt, kt, vt, is_causal=causal)
    gt = g.transpose(1, 2)
    return time_ms(
        torch,
        lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True),
        TIMED_LAUNCHES,
    )


def phase_bwd_kernels(torch):
    """Every (shape, dtype, causal, lse cotangent) case of both backward
    kernels, timed where there is no lse cotangent and the shape is
    square; returns the records."""
    records = []
    seed = 100
    cases = [(b, h, d, l, l) for b, h, d, l in KERNEL_SHAPES + [TRAIN_SHAPE]]
    for b, h, d, lq, lk in cases + EXTRA_CASES:
        for dtype in ("float32", "bfloat16"):
            for causal in (False, True):
                for with_lse in (False, True):
                    seed += 1
                    records += check_bwd_case(
                        torch, b, h, d, lq, lk, dtype, causal, with_lse,
                        seed, timed=not with_lse and lq == lk,
                    )
    return records


def phase_bwd_memory(torch):
    """The backward at a long sequence (bf16, causal) allocates no
    (L, L) buffer: the rise of the allocator's peak over the backward
    stays below one head's (L, L) float32 scores. What it must allocate
    is dq, dk, dv, delta and one float32 copy of dO."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    b, h, d, l = MEM_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, g = (
        torch.randn((b, l, h, d), generator=gen, device="cuda").to(
            torch.bfloat16
        )
        for _ in range(4)
    )
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    out, _ = fa.flash_attention_with_lse(q, k, v, True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    one_head_scores = l * l * 4
    rec = {
        "phase": "bwd_memory",
        "shape": [b, l, h, d],
        "dtype": "bfloat16",
        "backward_peak_rise_bytes": int(rise),
        "one_head_LxL_f32_bytes": one_head_scores,
        "grads_bytes": int(sum(x.numel() * x.element_size() for x in grads)),
        "finite": all(bool(torch.isfinite(x).all()) for x in grads),
    }
    emit(rec)
    if not (rise < one_head_scores and rec["finite"]):
        raise PhaseError("backward memory check failed: %s" % rec)
    return rec


def _make_artifact(torch, export_root):
    """The 110M bf16 artifact: seeded random weights through the port's
    ``export_model``; returns the seconds it took."""
    from elasticdl_tpu_torch.common.convert import to_named
    from elasticdl_tpu_torch.common.export import (
        export_model,
        export_provenance,
    )
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )

    t0 = time.perf_counter()
    with torch.device("meta"):
        model = zoo.custom_model(**SLICE_CFG)
    model = model.to_empty(device=DEVICE)
    zoo.init_parameters(
        model, torch.Generator(device=DEVICE).manual_seed(SEED)
    )
    named = to_named(
        model.state_dict(), SLICE_CFG["num_heads"], SLICE_CFG["head_dim"]
    )
    del model
    params = ",".join("%s=%r" % kv for kv in SLICE_CFG.items())
    export_model(
        os.path.join(export_root, "v1"),
        named,
        1,
        metadata=export_provenance("", MODEL_DEF, params),
    )
    return time.perf_counter() - t0


def _counter(name):
    from elasticdl_tpu_torch.utils import profiling

    return profiling.metrics.counter(name, labels=("outcome",))


def _forward_seconds():
    """Summed time of the scorer's forwards so far (each ends in a
    device synchronize), from its request-latency histogram."""
    from elasticdl_tpu_torch.utils import profiling

    got = profiling.metrics.histogram(
        "edl_scorer_request_latency_seconds"
    ).data()
    return got[1] if got else 0.0


def _fire(servicer, requests):
    """Every request at once, one thread each -> (replies, latencies in
    s, wall s from the first issue to the last reply)."""
    replies = [None] * len(requests)
    latency = [None] * len(requests)
    gate = threading.Barrier(len(requests) + 1)

    def one(i):
        gate.wait()
        t0 = time.perf_counter()
        replies[i] = servicer.score({"tokens": requests[i]})
        latency[i] = time.perf_counter() - t0

    threads = [
        threading.Thread(target=one, args=(i,), daemon=True)
        for i in range(len(requests))
    ]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise PhaseError("score requests still running after 300 s")
    return replies, latency, wall


def _check_reply(torch, reply, i):
    vocab = SLICE_CFG["vocab_size"]
    if "error" in reply:
        raise PhaseError("request %d failed: %s" % (i, reply["error"]))
    out = reply["output"]
    if not (
        isinstance(out, torch.Tensor)
        and out.dtype == torch.bfloat16
        and tuple(out.shape) == (1, SEQ_LEN, vocab)
        and bool(torch.isfinite(out).all())
    ):
        raise PhaseError(
            "request %d: expected finite bf16 logits (1, %d, %d), got %s %s"
            % (i, SEQ_LEN, vocab, getattr(out, "dtype", type(out)),
               tuple(getattr(out, "shape", ())))
        )
    if reply["model_version"] != 1:
        raise PhaseError(
            "request %d scored by v%s, expected v1"
            % (i, reply["model_version"])
        )


def _profile(torch, label, fn, **fields):
    """Device time by kernel over one call of ``fn`` (torch.profiler,
    after one unprofiled call); an empty breakdown says the profiler saw
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    rec = dict(
        fields,
        phase="profile",
        of=label,
        wall_ms=wall_ms,
        device_busy_ms=busy_ms,
        idle_share=(1 - busy_ms / wall_ms) if rows else None,
        top=[
            {"kernel": k[:90], "ms": us / 1e3, "calls": n}
            for us, k, n in rows[:15]
        ],
    )
    emit(rec)
    return rec


def _profile_forward(torch, model, tokens):
    def forward():
        with torch.inference_mode():
            model({"tokens": tokens})

    _profile(torch, "forward", forward, rows=int(tokens.shape[0]))


def _reset_counters():
    from elasticdl_tpu_torch.ops import flash_attention as fa

    for counter in (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches):
        counter.reset()


def _counts():
    from elasticdl_tpu_torch.ops import flash_attention as fa

    return {
        "flash_fwd": (fa.launches.count, fa.launches.shapes()),
        "flash_bwd_dq": (fa.bwd_dq_launches.count, fa.bwd_dq_launches.shapes()),
        "flash_bwd_dkv": (
            fa.bwd_dkv_launches.count, fa.bwd_dkv_launches.shapes()
        ),
    }


def phase_slice(torch, tmp):
    """Serve the 110M LM through the scorer's entry points; returns
    {"launches": flash launches of the served requests, "shapes": their
    launch shapes}."""
    import numpy as np

    from elasticdl_tpu_torch.common.args import parse_scorer_args
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.serving.main import build_scorer
    from elasticdl_tpu_torch.serving.server import ScorerServicer

    export_root = os.path.join(tmp, "exports")
    export_s = _make_artifact(torch, export_root)
    args = parse_scorer_args(
        [
            "--export_dir", export_root,
            "--device", DEVICE,
            "--serve_max_batch", str(MAX_BATCH),
            "--serve_batch_timeout_ms", "50",
        ]
    )
    scorer, watcher, batcher = build_scorer(args)
    t0 = time.perf_counter()
    if watcher.poll_once() != 1:
        raise PhaseError("the watcher did not install the v1 artifact")
    load_s = time.perf_counter() - t0
    servicer = ScorerServicer(scorer, batcher=batcher)
    batcher.start()
    try:
        rng = np.random.default_rng(SEED)
        requests = [
            rng.integers(0, SLICE_CFG["vocab_size"], (1, SEQ_LEN),
                         dtype=np.int32)
            for _ in range(N_REQUESTS)
        ]
        # warm-up (not counted): allocator, cuBLAS handles, a first batch
        _, _, warm_s = _fire(servicer, requests[:MAX_BATCH])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ok = _counter("edl_scorer_requests_total")
        forwards0 = ok.value(outcome="ok")
        forward_s0 = _forward_seconds()
        _reset_counters()
        replies, latency, wall = _fire(servicer, requests)
        launches = fa.launches.count
        shapes = fa.launches.shapes()
        bwd_launches = fa.bwd_dq_launches.count + fa.bwd_dkv_launches.count
        counts = _counts()
        forwards = int(ok.value(outcome="ok") - forwards0)
        forward_s = _forward_seconds() - forward_s0
        peak = torch.cuda.max_memory_allocated()
    finally:
        batcher.stop(drain=True)
        batcher.close()
    for i, reply in enumerate(replies):
        _check_reply(torch, reply, i)
    layers = SLICE_CFG["num_layers"]
    if forwards < 1 or launches != layers * forwards or bwd_launches:
        raise PhaseError(
            "flash_fwd launched %d times over %d forwards (expected %d "
            "per forward), the backward kernels %d times (expected 0)"
            % (launches, forwards, layers, bwd_launches)
        )

    # checks (not counted): each reply against its request scored solo,
    # and against the model with attention swapped for the plain version
    model = scorer.model().module
    solo_err = 0.0
    for i, req in enumerate(requests):
        solo, _ = scorer.score({"tokens": req})
        solo_err = max(
            solo_err,
            float((solo.float().cpu() - replies[i]["output"].float())
                  .abs().max()),
        )

    def plain_attention(q, k, v):
        return fa.plain_flash_with_lse(q, k, v, True)[0]

    plain_err = 0.0
    with torch.inference_mode():
        for s in range(0, N_REQUESTS, MAX_BATCH):
            chunk = np.concatenate(requests[s : s + MAX_BATCH])
            ref = model({"tokens": chunk}, attention_fn=plain_attention)
            got = torch.cat(
                [r["output"] for r in replies[s : s + MAX_BATCH]]
            )
            plain_err = max(
                plain_err,
                float((ref.float().cpu() - got.float()).abs().max()),
            )
    lat_ms = np.asarray(latency) * 1e3
    rec = {
        "phase": "slice",
        "model": dict(SLICE_CFG, params="float32"),
        "export_s": export_s,
        "load_s": load_s,
        "warmup_s": warm_s,
        "requests": N_REQUESTS,
        "seq_len": SEQ_LEN,
        "forwards": forwards,
        "rows_per_forward": N_REQUESTS / forwards,
        "forward_ms_mean": forward_s / forwards * 1e3,
        "flash_launches": launches,
        "flash_launches_per_forward": launches / forwards,
        "flash_bwd_launches": bwd_launches,
        "latency_p50_ms": float(np.percentile(lat_ms, 50)),
        "latency_p99_ms": float(np.percentile(lat_ms, 99)),
        "wall_s": wall,
        "tokens_per_s": N_REQUESTS * SEQ_LEN / wall,
        "max_memory_allocated": int(peak),
        "solo_max_abs_err": solo_err,
        "plain_attention_max_abs_err": plain_err,
        "atol": REPLY_ATOL,
    }
    emit(rec)
    if not (solo_err <= REPLY_ATOL and plain_err <= REPLY_ATOL):
        raise PhaseError(
            "served logits disagree: solo %.4g, plain attention %.4g "
            "(atol %g)" % (solo_err, plain_err, REPLY_ATOL)
        )
    _profile_forward(torch, model, np.concatenate(requests[:MAX_BATCH]))
    return counts


def _n_params(named):
    return sum(p.numel() for p in named.values())


def train_flops(n_params, batch, seq):
    """bench.py's model FLOPs of one step: 6 per parameter per token
    (forward and backward products; the tied head is inside n_params)
    plus causal attention, 3.5 x 2 b l^2 h d / 2 per layer."""
    cfg = SLICE_CFG
    attn = (
        3.5 * 2 * batch * seq * seq * cfg["num_heads"] * cfg["head_dim"] / 2
        * cfg["num_layers"]
    )
    return 6.0 * n_params * batch * seq + attn


def _clone_state(torch, ts, optimizer):
    """An independent copy of a train state (parameters and AdamW
    moments), for a check step that must not touch the trainer's."""
    import copy

    from elasticdl_tpu_torch.training.step import TrainState

    params = {
        n: p.detach().clone().requires_grad_(True)
        for n, p in ts.params.items()
    }
    opt = optimizer(list(params.values()))
    opt.load_state_dict(copy.deepcopy(ts.opt_state.state_dict()))
    return TrainState(params, dict(ts.state), opt, ts.version)


def _formula_attention(torch, f32_out=False):
    """Causal attention through the forward kernel, differentiated by
    ``plain_flash_bwd`` in float32 from the kernel's own out and lse: the
    function the backward kernels compute, without their bf16 products.
    With ``f32_out`` the backward takes delta from an output computed in
    float32 instead of the kernel's rounded one: what that rounding
    costs."""
    from elasticdl_tpu_torch.ops import flash_attention as fa

    class KernelFwdPlainBwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = fa._flash_fwd_kernel(q, k, v, True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, out, lse = ctx.saved_tensors
            if f32_out:
                out = fa.plain_flash_with_lse(
                    q.float(), k.float(), v.float(), True
                )[0]
            return fa.plain_flash_bwd(q, k, v, out, lse, g, True)

    return KernelFwdPlainBwd.apply


def _grad_checks(torch, model, loss_fn, weights, tokens):
    """Gradients of one batch from ``weights`` through the kernels
    (``make_grad_fn``, the training path) against (1) the model with
    ``use_flash=False`` (plain attention) and (2) the same forward kernel
    with ``plain_flash_bwd`` as the backward; and (3) that backward with
    a float32 delta against plain attention. Per comparison, the losses
    and the worst and median per-tensor relative L2 difference."""
    from torch.func import functional_call

    from elasticdl_tpu_torch.training.step import make_grad_fn

    grad_fn = make_grad_fn(model, loss_fn)
    feats = {"tokens": tokens}
    kernel = grad_fn(weights, {}, feats, tokens)[:2]
    model.use_flash = False
    try:
        plain = grad_fn(weights, {}, feats, tokens)[:2]
    finally:
        model.use_flash = True

    def formula(f32_out):
        leaves = {
            n: w.detach().requires_grad_(True) for n, w in weights.items()
        }
        out = functional_call(
            model, leaves, (feats,),
            {"attention_fn": _formula_attention(torch, f32_out)},
        )
        loss = loss_fn(out, tokens)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def compare(a, b):
        (loss_a, grads_a), (loss_b, grads_b) = a, b
        rel = {n: _rel_l2(torch, grads_a[n], grads_b[n]) for n in grads_a}
        worst = max(rel, key=rel.get)
        return {
            "loss": float(loss_a),
            "loss_other": float(loss_b),
            "max_rel_l2": rel[worst],
            "worst_tensor": worst,
            "median_rel_l2": float(sorted(rel.values())[len(rel) // 2]),
        }

    return {
        "plain_attention": compare(kernel, plain),
        "plain_flash_bwd": compare(kernel, formula(False)),
        "f32_delta_vs_plain_attention": compare(formula(True), plain),
    }


def _check_counts(counts, want, what):
    got = {name: n for name, (n, _) in counts.items()}
    if got != want:
        raise PhaseError(
            "%s launched %s; expected %s" % (what, got, want)
        )


def phase_train(torch):
    """Train the 110M LM through ``AllReduceTrainer.train_step``; returns
    the launch counts of the timed steps (the main path)."""
    import numpy as np

    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer
    from elasticdl_tpu_torch.training import step as tstep

    layers = SLICE_CFG["num_layers"]
    vocab = SLICE_CFG["vocab_size"]
    with torch.device("meta"):
        model = zoo.custom_model(**SLICE_CFG)
    optimizer = zoo.optimizer(LR)
    trainer = AllReduceTrainer(
        model, zoo.loss, optimizer, seed=SEED, device=DEVICE
    )
    rng = np.random.default_rng(SEED)
    batches = [
        rng.integers(0, vocab, (TRAIN_BATCH, SEQ_LEN), dtype=np.int32)
        for _ in range(1 + TRAIN_STEPS)
    ]

    def step(tokens):
        return trainer.train_step({"tokens": tokens}, tokens)

    t0 = time.perf_counter()
    trainer.init_from_batch(batches[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_weights = {
        n: p.detach().clone() for n, p in trainer.train_state.params.items()
    }
    t0 = time.perf_counter()
    warm_loss = float(step(batches[0]))  # warm-up, not timed
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    step_ms, losses = [], []
    for tokens in batches[1:]:
        t0 = time.perf_counter()
        losses.append(step(tokens))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [warm_loss] + [float(x) for x in losses]
    ts = trainer.train_state
    params = ts.params
    n_params = _n_params(params)

    # the main path's checks
    if not all(np.isfinite(losses)):
        raise PhaseError("non-finite training loss: %s" % losses)
    if trainer.version != 1 + TRAIN_STEPS:
        raise PhaseError(
            "version %d after %d steps" % (trainer.version, 1 + TRAIN_STEPS)
        )
    _check_counts(
        counts,
        {k: layers * TRAIN_STEPS for k in KERNELS},
        "%d train steps" % TRAIN_STEPS,
    )
    # the step leaves each parameter's gradient in .grad (a parameter
    # the loss does not reach gets zeros): every one finite and nonzero
    bad_grad = [
        n for n, p in params.items() if not bool(torch.isfinite(p.grad).all())
    ]
    zero_grad = [
        n for n, p in params.items() if not float(p.grad.abs().max()) > 0
    ]
    if bad_grad or zero_grad:
        raise PhaseError(
            "gradients: non-finite for %s, zero for %s" % (bad_grad, zero_grad)
        )

    # checks (not counted): kernel gradients against plain attention
    # (gated from the seeded init, reported from the trained weights) and
    # against plain_flash_bwd on the same forward (gated from both), then
    # one rematerialized step from the trained state, on one batch
    tokens = rng.integers(0, vocab, (GRAD_CHECK_BATCH, SEQ_LEN),
                          dtype=np.int32)
    init_check = _grad_checks(torch, model, zoo.loss, init_weights, tokens)
    del init_weights
    trained_check = _grad_checks(
        torch, model, zoo.loss,
        {n: p.detach() for n, p in params.items()}, tokens,
    )
    loss_k = trained_check["plain_attention"]["loss"]
    remat = {}
    for on in (False, True):
        clone = _clone_state(torch, ts, optimizer)
        check_step = tstep.make_train_step(model, zoo.loss, remat=on)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        loss = check_step(clone, {"tokens": tokens}, tokens)[1]
        remat[on] = {
            "loss": float(loss),
            "launches": {k: v[0] for k, v in _counts().items()},
            "peak_rise_bytes": int(
                torch.cuda.max_memory_allocated() - base
            ),
        }
        del clone
    for on, fwd in ((False, layers), (True, 2 * layers)):
        _check_counts(
            {k: (n, None) for k, n in remat[on]["launches"].items()},
            {"flash_fwd": fwd, "flash_bwd_dq": layers,
             "flash_bwd_dkv": layers},
            "one step with remat=%s" % on,
        )

    med = float(np.median(step_ms))
    tokens_per_step = TRAIN_BATCH * SEQ_LEN
    flops = train_flops(n_params, TRAIN_BATCH, SEQ_LEN)
    rec = {
        "phase": "train",
        "model": dict(SLICE_CFG, params="float32", n_params=n_params),
        "optimizer": "AdamW lr %g wd 1e-4" % LR,
        "batch": TRAIN_BATCH,
        "seq_len": SEQ_LEN,
        "steps_timed": TRAIN_STEPS,
        "init_s": init_s,
        "warmup_s": warm_s,
        "step_ms": step_ms,
        "step_ms_median": med,
        "tokens_per_s": tokens_per_step / med * 1e3,
        "flops_per_step": flops,
        "mfu": flops / (med / 1e3) / PEAK_OPS_PER_S["bfloat16"],
        "max_memory_allocated": int(peak),
        "losses": losses,
        "version": trainer.version,
        "launches": {k: v[0] for k, v in counts.items()},
        "grad_check": {
            "batch": GRAD_CHECK_BATCH,
            "vs_plain_attention": {
                "seeded_init": init_check["plain_attention"],
                "trained": trained_check["plain_attention"],
                "rel_l2_limit": GRAD_REL_L2,
                "gated": "seeded_init",
            },
            "vs_plain_flash_bwd": {
                "seeded_init": init_check["plain_flash_bwd"],
                "trained": trained_check["plain_flash_bwd"],
                "rel_l2_limit": FORMULA_REL_L2,
                "gated": "both",
            },
            "plain_flash_bwd_f32_delta_vs_plain_attention": {
                "seeded_init": init_check["f32_delta_vs_plain_attention"],
                "trained": trained_check["f32_delta_vs_plain_attention"],
                "gated": "neither (says what the bf16 delta costs)",
            },
            "trained_after_steps": 1 + TRAIN_STEPS,
        },
        "remat": dict(remat[True], batch=GRAD_CHECK_BATCH),
        "no_remat": dict(remat[False], batch=GRAD_CHECK_BATCH),
    }
    emit(rec)
    gated = [(init_check["plain_attention"], GRAD_REL_L2)] + [
        (check["plain_flash_bwd"], FORMULA_REL_L2)
        for check in (init_check, trained_check)
    ]
    for got, limit in gated:
        if got["max_rel_l2"] > limit or not np.isclose(
            got["loss"], got["loss_other"], rtol=limit
        ):
            raise PhaseError(
                "kernel gradients disagree: %s (limit %g)" % (got, limit)
            )
    for on in (False, True):
        if abs(remat[on]["loss"] - loss_k) > REMAT_LOSS_RTOL * abs(loss_k):
            raise PhaseError(
                "remat=%s step loss %r differs from %r"
                % (on, remat[on]["loss"], loss_k)
            )
    _profile(
        torch, "train_step", lambda: float(step(batches[-1])),
        batch=TRAIN_BATCH, seq_len=SEQ_LEN,
    )
    return counts


# ---------------------------------------------------------------------------
# the single-process ALLREDUCE job (ResNet-50)
# ---------------------------------------------------------------------------

JOB_MODEL_DEF = "imagenet_resnet50.imagenet_resnet50.custom_model"
JOB_RECORDS = 896  # synthetic ImageNet-shaped records (bench.py's shape)
JOB_IMAGE = 224
JOB_CLASSES = 1000
JOB_MODEL_PARAMS = ""  # the zoo's defaults (bf16) at JOB_CLASSES classes
JOB_BATCH = 64
JOB_MINIBATCHES_PER_TASK = 2
JOB_CKPT_STEPS = 4
# the profiled job's windows, steps [first, last) from 0: three steps
# between checkpoints, then the step before the v8 checkpoint, the
# checkpoint and the step after it (a window ends as its last step
# starts, so the checkpoint written before step 8 lies inside)
JOB_PROFILE_WINDOWS = {"steps": (4, 7), "checkpoint": (7, 9)}
FUSED_BATCH = 128  # bench.py's bench_resnet step
FUSED_STEPS = 20  # timed, after warm-up
FUSED_WARMUP = 3
# bf16 against f32 from one seeded init on one batch: the outputs by
# relative L2 and the first step's loss, relatively. bf16 keeps 8
# mantissa bits (2^-8 = 0.4 % per rounding) and the network rounds its
# activations at ~100 convolutions and norms; as independent errors that
# is ~4 %, so 5e-2 passes a sound bf16 path and fails a wrong one (a
# missing 1/255 or a swapped layout moves the outputs by O(1)).
BF16_OUT_REL_L2 = 5e-2
BF16_LOSS_RTOL = 1e-2


def write_job_records(torch, data_dir):
    """JOB_RECORDS synthetic records from SEED (uint8 images, labels 1..
    JOB_CLASSES) as one RecordIO file; returns the seconds it took."""
    import numpy as np

    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    os.makedirs(data_dir, exist_ok=True)
    with RecordIOWriter(os.path.join(data_dir, "train-0")) as w:
        for _ in range(JOB_RECORDS):
            w.write(
                encode_example(
                    {
                        "image": rng.integers(
                            0, 256, (JOB_IMAGE, JOB_IMAGE, 3), dtype=np.uint8
                        ),
                        "label": np.array(
                            [rng.integers(1, JOB_CLASSES + 1)], np.int64
                        ),
                    }
                )
            )
    return time.perf_counter() - t0


def job_argv(data_dir, ckpt_dir, out_dir=None):
    argv = [
        "train",
        "--job_name", "chip-smoke-resnet50",
        "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", "0",
        "--model_zoo", os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo"),
        "--model_def", JOB_MODEL_DEF,
        "--model_params", JOB_MODEL_PARAMS or "num_classes=%d" % JOB_CLASSES,
        "--training_data", data_dir,
        "--minibatch_size", str(JOB_BATCH),
        "--num_minibatches_per_task", str(JOB_MINIBATCHES_PER_TASK),
        "--num_epochs", "1",
        "--checkpoint_dir", ckpt_dir,
        "--checkpoint_steps", str(JOB_CKPT_STEPS),
        "--device", DEVICE,
        "--log_level", "WARNING",
    ]
    if out_dir:
        argv += ["--output", out_dir]
    return argv


class _StepClock:
    """Times every ``AllReduceWorker._train_batch`` (a step ends in the
    worker's own ``float(loss)``, a device sync) while installed; calls
    ``on_step(i)`` before step i (from 0)."""

    def __init__(self, on_step=None):
        from elasticdl_tpu_torch.worker.allreduce_worker import (
            AllReduceWorker,
        )

        self._cls = AllReduceWorker
        self._orig = AllReduceWorker._train_batch
        self.spans = []  # (start, end) perf_counter seconds
        self._on_step = on_step

    def __enter__(self):
        clock, orig = self, self._orig

        def timed(worker, batch):
            if clock._on_step is not None:
                clock._on_step(len(clock.spans))
            t0 = time.perf_counter()
            try:
                return orig(worker, batch)
            finally:
                clock.spans.append((t0, time.perf_counter()))

        self._cls._train_batch = timed
        return self

    def __exit__(self, *exc):
        self._cls._train_batch = self._orig
        return False


def resnet_flops_per_image(torch, model):
    """Model FLOPs of one training image: 3 x the forward's
    multiply-adds x 2 over every convolution and the dense head (the
    backward does two products per forward product), from the layer
    shapes of one JOB_IMAGE forward."""
    from elasticdl_tpu_torch.nn.layers import Conv

    fwd = []

    def conv_hook(m, inputs, out):
        cout, cin, kh, kw = m.weight.shape
        fwd.append(2.0 * kh * kw * cin * cout * out.shape[2] * out.shape[3])

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, Conv)]
    try:
        with torch.no_grad():
            model.eval()
            model({"image": torch.zeros(
                (1, JOB_IMAGE, JOB_IMAGE, 3), dtype=torch.uint8,
                device=model.head.weight.device,
            )})
    finally:
        for h in hooks:
            h.remove()
    fwd.append(2.0 * model.head.in_features * model.head.out_features)
    return 3.0 * sum(fwd), sum(fwd)


def phase_fused_step(torch, card):
    """bench.py's fused ResNet-50 step: b128 at 224x224, uint8 images and
    labels resident on the card, bf16 compute, SGD with momentum, through
    ``AllReduceTrainer.train_step``; FUSED_STEPS timed after warm-up."""
    import numpy as np

    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as zoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    model = zoo.custom_model(num_classes=JOB_CLASSES)
    trainer = AllReduceTrainer(
        model, zoo.loss, zoo.optimizer(), seed=SEED, device=DEVICE
    )
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    images = torch.randint(
        0, 256, (FUSED_BATCH, JOB_IMAGE, JOB_IMAGE, 3), generator=gen,
        device=DEVICE, dtype=torch.uint8,
    )
    labels = torch.randint(
        0, JOB_CLASSES, (FUSED_BATCH, 1), generator=gen, device=DEVICE,
        dtype=torch.int32,
    )
    feats = {"image": images}
    trainer.init_from_batch((feats, labels))
    flops, fwd_flops = resnet_flops_per_image(torch, model)
    for _ in range(FUSED_WARMUP):
        trainer.train_step(feats, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(FUSED_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(feats, labels))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise PhaseError("fused step: non-finite loss %s" % losses)
    med = float(np.median(step_ms))
    rec = {
        "phase": "fused_step",
        "card": card,
        "model": "imagenet_resnet50 bf16 (params float32), %d classes"
        % JOB_CLASSES,
        "batch": FUSED_BATCH,
        "image": JOB_IMAGE,
        "optimizer": "SGD lr 0.02 momentum 0.9",
        "steps_timed": FUSED_STEPS,
        "step_ms": step_ms,
        "step_ms_median": med,
        "examples_per_s": FUSED_BATCH / med * 1e3,
        "model_flops_per_image": flops,
        "forward_flops_per_image": fwd_flops,
        "mfu": flops * FUSED_BATCH / (med / 1e3) / PEAK_OPS_PER_S["bfloat16"],
        "max_memory_allocated": int(peak),
        "losses": losses,
    }
    emit(rec)
    return rec


def _bf16_vs_f32(torch, data_dir):
    """One batch of the job's records through the bf16 and the f32 model
    from one seeded init: the eval outputs (relative L2) and the first
    training step's loss."""
    from elasticdl_tpu_torch.common.constants import Mode
    from elasticdl_tpu_torch.data.data_reader import create_data_reader
    from elasticdl_tpu_torch.data.dataset import create_dataset_from_tasks
    from elasticdl_tpu_torch.master.task_dispatcher import Task
    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as zoo,
    )
    from elasticdl_tpu_torch.nn.model_api import init_variables
    from elasticdl_tpu_torch.training.step import make_forward_fn, make_grad_fn

    reader = create_data_reader(data_dir)
    shard = next(iter(reader.create_shards()))
    ds = zoo.dataset_fn(
        create_dataset_from_tasks(
            [Task(shard, 0, JOB_BATCH, 0)], reader
        ),
        Mode.EVALUATION,
        None,
    )
    features, labels = next(iter(ds.batch(JOB_BATCH).device_prefetch(DEVICE)))
    out, loss = {}, {}
    weights = None
    for dtype in ("float32", "bfloat16"):
        model = zoo.custom_model(num_classes=JOB_CLASSES, dtype=dtype).to(
            DEVICE
        )
        if weights is None:
            variables = init_variables(model, SEED)
            weights = {k: v.detach().clone() for k, v in
                       {**variables["params"], **variables["state"]}.items()}
        params = {k: weights[k] for k, _ in model.named_parameters()}
        state = {k: weights[k] for k, _ in model.named_buffers()}
        out[dtype] = make_forward_fn(model)(params, state, features)
        loss[dtype] = float(
            make_grad_fn(model, zoo.loss)(params, state, features, labels)[0]
        )
    reader.close()
    rel = _rel_l2(torch, out["bfloat16"], out["float32"])
    loss_rel = abs(loss["bfloat16"] - loss["float32"]) / abs(loss["float32"])
    return {
        "batch": JOB_BATCH,
        "out_rel_l2": rel,
        "out_rel_l2_limit": BF16_OUT_REL_L2,
        "out_max_abs_err": float(
            (out["bfloat16"] - out["float32"]).abs().max()
        ),
        "loss_bf16": loss["bfloat16"],
        "loss_f32": loss["float32"],
        "loss_rel": loss_rel,
        "loss_rtol": BF16_LOSS_RTOL,
        "ok": rel <= BF16_OUT_REL_L2 and loss_rel <= BF16_LOSS_RTOL,
    }


def _device_intervals(prof):
    """[(start us, end us, name)] of the device's kernels and copies."""
    from torch.autograd import DeviceType

    out = []
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            out.append((evt.time_range.start, evt.time_range.end, evt.name))
    return sorted(out)


def _window_record(torch, prof, wall_ms):
    """Device busy (the union of kernel and copy intervals) against the
    host's wall, the top device ops and the largest device-idle gaps of
    one profiled window."""
    spans = _device_intervals(prof)
    busy_us, gaps, end = 0.0, [], None
    for start, stop, name in spans:
        if end is None or start > end:
            if end is not None:
                gaps.append(((start - end) / 1e3, name))
            busy_us += stop - start
            end = stop
        elif stop > end:
            busy_us += stop - end
            end = stop
    busy_ms = busy_us / 1e3
    gaps.sort(reverse=True)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if spans else None,
        "idle_share": (1 - busy_ms / wall_ms) if spans else None,
        "device_gap_ms_total": sum(g for g, _ in gaps),
        "largest_gaps": [{"ms": g, "before": n[:90]} for g, n in gaps[:8]],
        "top": [
            {"kernel": k[:90], "ms": us / 1e3, "calls": n}
            for us, k, n in _device_rows(prof)[:15]
        ],
    }


def _profile_job(torch, data_dir, ckpt_dir, card):
    """A second job run with torch.profiler on over each window of
    JOB_PROFILE_WINDOWS (from the start of its first step to the start
    of its last), one record each."""
    from torch.profiler import ProfilerActivity, profile

    from elasticdl_tpu_torch import cli

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    profs = {w: profile(activities=activities) for w in JOB_PROFILE_WINDOWS}
    marks = {}

    def on_step(i):
        for window, (first, last) in JOB_PROFILE_WINDOWS.items():
            if i in (first, last):
                torch.cuda.synchronize()
                marks[window, i] = time.perf_counter()
                if i == first:
                    profs[window].start()
                else:
                    profs[window].stop()

    with _StepClock(on_step):
        rc = cli.main(job_argv(data_dir, ckpt_dir))
    out = {}
    for window, (first, last) in JOB_PROFILE_WINDOWS.items():
        if rc != 0 or (window, last) not in marks:
            raise PhaseError("the profiled job ended rc=%s before step %d"
                             % (rc, last))
        wall_ms = (marks[window, last] - marks[window, first]) * 1e3
        out[window] = rec = dict(
            _window_record(torch, profs[window], wall_ms),
            phase="profile",
            of="job_%s" % window,
            steps=[first, last],
            batch=JOB_BATCH,
            card=card,
        )
        emit(rec)
    return out


def phase_job(torch, tmp, fused, card):
    """The single-process ALLREDUCE job through the port's command line
    in this process: master -> task dispatcher -> AllReduceWorker ->
    RecordIO reader, ResNet-50 (bf16, 1000 classes) on JOB_RECORDS
    synthetic records. Returns the flash kernels' launch counts of the
    job (ResNet-50 launches none)."""
    import glob

    import numpy as np

    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as zoo,
    )
    from elasticdl_tpu_torch.parallel.trainer import AllReduceTrainer

    data_dir = os.path.join(tmp, "job-data")
    ckpt_dir = os.path.join(tmp, "job-ckpt")
    out_dir = os.path.join(tmp, "job-export")
    write_s = write_job_records(torch, data_dir)
    jobs = []
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    with _StepClock() as clock:
        rc = cli.main(job_argv(data_dir, ckpt_dir, out_dir), jobs=jobs)
    job_s = time.perf_counter() - t0
    counts = _counts()
    job = jobs[0]
    trainer = job.worker.trainer
    steps = JOB_RECORDS // JOB_BATCH
    losses = job.losses or []

    # the job's outcome
    problems = []
    if rc != 0:
        problems.append("exit code %s" % rc)
    if not job.master.task_d.finished():
        problems.append("the dispatcher has tasks left")
    if trainer.version != steps:
        problems.append("version %d, expected %d" % (trainer.version, steps))
    if len(losses) != steps or not all(np.isfinite(losses)):
        problems.append("losses %s" % losses)
    ts = trainer.train_state
    bad = [n for n, p in ts.params.items()
           if not bool(torch.isfinite(p).all())]
    if bad:
        problems.append("non-finite params %s" % bad)
    moved = sum(
        1 for n, b in ts.state.items()
        if not torch.equal(
            b, torch.zeros_like(b) if n.endswith("mean") else
            torch.ones_like(b)
        )
    )
    if moved != len(ts.state):
        problems.append("%d of %d batch statistics never moved"
                        % (len(ts.state) - moved, len(ts.state)))
    ckpts = sorted(glob.glob(os.path.join(ckpt_dir, "ckpt_v*")))
    newest = max(ckpts, key=lambda d: int(d.rsplit("_v", 1)[1]),
                 default=None)
    restored_equal = False
    if newest is None:
        problems.append("no ckpt_v* directory")
    else:
        fresh = AllReduceTrainer(
            zoo.custom_model(num_classes=JOB_CLASSES), zoo.loss,
            zoo.optimizer(), seed=SEED + 1, device=DEVICE,
        )
        fresh.init_from_batch(None)
        version = fresh.restore_sharded(newest)
        rs = fresh.train_state
        restored_equal = (
            version == trainer.version
            and all(torch.equal(rs.params[n], p) for n, p in ts.params.items())
            and all(torch.equal(rs.state[n], b) for n, b in ts.state.items())
        )
        if not restored_equal:
            problems.append("restoring %s is not bitwise the final state"
                            % newest)
        del fresh, rs
    manifests = glob.glob(os.path.join(out_dir, "*", "MANIFEST.json"))
    if not manifests:
        problems.append("no export manifest under %s" % out_dir)
    bf16 = _bf16_vs_f32(torch, data_dir)
    if not bf16["ok"]:
        problems.append("bf16 against f32: %s" % bf16)

    # timed steps: the first excluded (it waits for the whole shuffle
    # buffer: the zoo shuffles 1024 records, more than the job has)
    spans = clock.spans
    timed_s = spans[-1][1] - spans[0][1] if len(spans) > 1 else float("nan")
    in_step_s = sum(e - s for s, e in spans[1:])
    job_eps = (len(spans) - 1) * JOB_BATCH / timed_s
    stats = job.worker.input_stats.snapshot()
    rec = {
        "phase": "job",
        "card": card,
        "model": JOB_MODEL_DEF + " (bf16, params float32)",
        "records": JOB_RECORDS,
        "image": JOB_IMAGE,
        "batch": JOB_BATCH,
        "records_per_task": JOB_BATCH * JOB_MINIBATCHES_PER_TASK,
        "checkpoint_steps": JOB_CKPT_STEPS,
        "write_records_s": write_s,
        "job_s": job_s,
        "first_step_end_s": spans[0][1] - t0 if spans else None,
        "steps": len(spans),
        "version": trainer.version,
        "losses": losses,
        "step_ms": [(e - s) * 1e3 for s, e in spans],
        "timed_steps": len(spans) - 1,
        "timed_s": timed_s,
        "timed_in_step_s": in_step_s,
        "timed_between_steps_s": timed_s - in_step_s,
        "examples_per_s": job_eps,
        "fused_examples_per_s": fused["examples_per_s"],
        "job_over_fused": job_eps / fused["examples_per_s"],
        "input_stats": stats,
        "checkpoints": [os.path.basename(d) for d in ckpts],
        "restore_bitwise": restored_equal,
        "export_manifests": len(manifests),
        "bf16_vs_f32": bf16,
        "launches": {k: v[0] for k, v in counts.items()},
    }
    emit(rec)
    if problems:
        raise PhaseError("job: " + "; ".join(problems))
    del job, trainer, ts, jobs
    _profile_job(
        torch, data_dir, os.path.join(tmp, "job-ckpt-profiled"), card
    )
    return counts, rec


# ---------------------------------------------------------------------------
# evaluation: interleaved rounds, evaluation-only and prediction-only jobs
# ---------------------------------------------------------------------------

EVAL_RECORDS = 256  # validation records: 4 batches, 2 tasks of 128
EVAL_STEPS = 4  # a round each time the version passes 4, 8, 12
# a round's accuracy against the direct forward of its checkpoint: at
# most 2 of the records may differ (cuDNN picks its algorithms per call,
# so a near-tie can flip)
EVAL_TOL_RECORDS = 2
# bf16 outputs of a round or of the predict job against the direct
# forward, by relative L2 (the same inputs and weights: only cuDNN's
# choices of algorithm may differ)
EVAL_REL_L2 = 1e-2


def write_records(data_dir, images, labels):
    """One RecordIO file of (image, label) records; returns seconds."""
    import numpy as np

    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.data.recordio import RecordIOWriter

    t0 = time.perf_counter()
    os.makedirs(data_dir, exist_ok=True)
    with RecordIOWriter(os.path.join(data_dir, "records-0")) as w:
        for image, label in zip(images, labels):
            w.write(encode_example(
                {"image": image, "label": np.array([label], np.int64)}
            ))
    return time.perf_counter() - t0


class _Timed:
    """Times every call of ``cls.name`` while installed: ``calls`` holds
    (``key(first argument)`` or None, seconds)."""

    def __init__(self, cls, name, key=None):
        self._cls, self._name, self._key = cls, name, key
        self._orig = getattr(cls, name)
        self.calls = []

    def __enter__(self):
        timer, orig, key = self, self._orig, self._key

        def timed(obj, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(obj, *args, **kwargs)
            finally:
                arg = key(args[0]) if key and args else None
                timer.calls.append((arg, time.perf_counter() - t0))

        setattr(self._cls, self._name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self._cls, self._name, self._orig)
        return False


class _EvalReports:
    """Every evaluation report's pinned version and outputs, in order,
    and its labels counted by version."""

    def __init__(self):
        from elasticdl_tpu_torch.master.servicer import MasterServicer

        self._cls = MasterServicer
        self._orig = MasterServicer.report_evaluation_metrics
        self.records = {}
        self.outputs = []  # (version, outputs of the report's task)

    def __enter__(self):
        reports, orig = self, self._orig

        def spy(servicer, version, outputs, labels, scored_version=None):
            reports.records[version] = (
                reports.records.get(version, 0) + len(labels)
            )
            reports.outputs.append((version, outputs["output"]))
            return orig(servicer, version, outputs, labels,
                        scored_version=scored_version)

        self._cls.report_evaluation_metrics = spy
        return self

    def __exit__(self, *exc):
        self._cls.report_evaluation_metrics = self._orig
        return False


def _checkpoint_weights(torch, directory):
    """(params, state) of a sharded checkpoint, on the card."""
    from elasticdl_tpu_torch.common.sharded_checkpoint import (
        load_sharded_to_host,
    )

    _, leaves = load_sharded_to_host(directory)
    params, state = {}, {}
    for path, value in leaves.items():
        head, _, name = path.partition("/")
        if head in ("params", "state"):
            (params if head == "params" else state)[name] = value.to(DEVICE)
    return params, state


def _export_weights(torch, export_dir):
    """(params, fresh BatchNorm statistics) of an export artifact: the
    artifact carries parameters only."""
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.common.model_utils import (
        load_from_checkpoint_file,
    )

    _, named = load_from_checkpoint_file(export_dir)
    params = {k: v.to(DEVICE) for k, v in convert.to_state_dict(named).items()}
    state = {k: b.to(DEVICE) for k, b in job_model().named_buffers()}
    return params, state


def job_model():
    """The job's model, built from its --model_params."""
    from elasticdl_tpu_torch.common.model_utils import build_model

    return build_model(
        JOB_MODEL_DEF, JOB_MODEL_PARAMS or "num_classes=%d" % JOB_CLASSES
    )


def _direct_forward(torch, params, state, images):
    """The zoo model's inference forward (BatchNorm on running
    statistics) over ``images`` at JOB_BATCH: outputs as float32 on the
    card."""
    from elasticdl_tpu_torch.training.step import make_forward_fn

    fwd = make_forward_fn(job_model().to(DEVICE))
    out = []
    for i in range(0, len(images), JOB_BATCH):
        x = torch.from_numpy(images[i:i + JOB_BATCH]).to(DEVICE)
        out.append(fwd(params, state, {"image": x}).float())
    return torch.cat(out)


def _accuracy(torch, outputs, labels):
    """Share of rows whose argmax is the zoo's label (stored label - 1)."""
    want = torch.as_tensor(labels - 1, device=outputs.device)
    return float((outputs.argmax(1) == want).float().mean())


def serving_argv(verb, data_flag, data_dir, source_flag, source, zoo):
    return [
        verb,
        "--job_name", "chip-smoke-resnet50-" + verb,
        "--distribution_strategy", "AllreduceStrategy",
        "--num_workers", "0",
        "--model_zoo", zoo,
        "--model_def", JOB_MODEL_DEF,
        "--model_params", JOB_MODEL_PARAMS or "num_classes=%d" % JOB_CLASSES,
        data_flag, data_dir,
        source_flag, source,
        "--minibatch_size", str(JOB_BATCH),
        "--num_minibatches_per_task", str(JOB_MINIBATCHES_PER_TASK),
        "--device", DEVICE,
        "--log_level", "WARNING",
    ]


def _scoring_job(torch, argv, what):
    """Run an evaluate or predict job; returns (job, wall seconds, the
    drain's run seconds, per-eval-task seconds)."""
    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.worker.elastic_allreduce_worker import (
        ElasticAllReduceWorker,
    )

    jobs = []
    t0 = time.perf_counter()
    with _Timed(ElasticAllReduceWorker, "run") as run, _Timed(
        ElasticAllReduceWorker, "_process_eval_task"
    ) as tasks:
        rc = cli.main(argv, jobs=jobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0 or not jobs[0].master.task_d.finished():
        raise PhaseError("%s: exit code %s, tasks left %s" % (
            what, rc, jobs[0].master.task_d.queue_depths()))
    return jobs[0], wall, run.calls[0][1], [s for _, s in tasks.calls]


def phase_eval(torch, tmp, job_rec, card):
    """The evaluation plane through the port's command line, on
    ResNet-50 at the job phase's settings. Returns the flash kernels'
    launch counts over the phase (ResNet-50 launches none)."""
    import numpy as np

    from elasticdl_tpu_torch import cli
    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as zoo,
    )
    from elasticdl_tpu_torch.worker.allreduce_worker import AllReduceWorker

    tol = EVAL_TOL_RECORDS / EVAL_RECORDS
    problems = []
    data_dir = os.path.join(tmp, "job-data")  # the job phase's records
    val_dir = os.path.join(tmp, "eval-val")
    ckpt_dir = os.path.join(tmp, "eval-ckpt")
    out_dir = os.path.join(tmp, "eval-export")
    rng = np.random.default_rng(SEED + 1)
    images = rng.integers(0, 256, (EVAL_RECORDS, JOB_IMAGE, JOB_IMAGE, 3),
                          dtype=np.uint8)
    labels = rng.integers(1, JOB_CLASSES + 1, EVAL_RECORDS)
    write_s = write_records(val_dir, images, labels)
    torch.cuda.synchronize()
    _reset_counters()

    # 1. training with interleaved rounds
    jobs = []
    argv = job_argv(data_dir, ckpt_dir, out_dir) + [
        "--validation_data", val_dir, "--evaluation_steps", str(EVAL_STEPS),
    ]
    t0 = time.perf_counter()
    with _StepClock() as clock, _EvalReports() as reports, _Timed(
        AllReduceWorker, "_process_eval_task",
        key=lambda task: (task.model_version, task.start),
    ) as eval_tasks:
        rc = cli.main(argv, jobs=jobs)
    job_s = time.perf_counter() - t0
    job = jobs[0]
    steps = JOB_RECORDS // JOB_BATCH
    want_rounds = list(range(EVAL_STEPS, steps + 1, EVAL_STEPS))
    published = job.master.evaluation_service.published
    if rc != 0 or job.worker.trainer.version != steps:
        problems.append("train with evaluation: exit code %s, version %d"
                        % (rc, job.worker.trainer.version))
    if [r["version"] for r in published] != want_rounds:
        problems.append("rounds at %s, expected %s"
                        % ([r["version"] for r in published], want_rounds))
    if reports.records != {v: EVAL_RECORDS for v in want_rounds}:
        problems.append("records scored per round %s" % reports.records)
    # each task reports once, in the order the tasks were scored
    scored = [(key, out) for (key, _), (_, out) in
              zip(eval_tasks.calls, reports.outputs)]
    rounds = []
    for r in published:
        v = r["version"]
        directory = os.path.join(ckpt_dir, "ckpt_v%d" % v)
        params, state = _checkpoint_weights(torch, directory)
        direct_out = _direct_forward(torch, params, state, images)
        direct = _accuracy(torch, direct_out, labels)
        got = r["metrics"]["accuracy"]
        rows = [out for _, out in sorted(
            ((k[1], o) for k, o in scored if k[0] == v),
            key=lambda start_out: start_out[0])]
        rel = (_rel_l2(torch, torch.from_numpy(np.concatenate(rows)).to(
            direct_out.device), direct_out) if rows else None)
        rounds.append({
            "version": v,
            "accuracy": got,
            "direct_accuracy": direct,
            "outputs_rel_l2": rel,
            "seconds": sum(sec for k, sec in eval_tasks.calls
                           if k[0] == v),
        })
        if abs(got - direct) > tol + 1e-12:
            problems.append("round v%d reads %s, its checkpoint's direct "
                            "forward %s" % (v, got, direct))
        if rel is None or rel > EVAL_REL_L2:
            problems.append("round v%d outputs %s from its checkpoint's "
                            "direct forward (relative L2)" % (v, rel))
    spans = clock.spans
    timed_s = spans[-1][1] - spans[0][1] if len(spans) > 1 else float("nan")
    eps = (len(spans) - 1) * JOB_BATCH / timed_s
    emit({
        "phase": "eval",
        "of": "train_with_evaluation",
        "card": card,
        "model": JOB_MODEL_DEF + " (bf16, params float32)",
        "records": JOB_RECORDS,
        "eval_records": EVAL_RECORDS,
        "write_eval_records_s": write_s,
        "evaluation_steps": EVAL_STEPS,
        "job_s": job_s,
        "steps": len(spans),
        "timed_s": timed_s,
        "timed_in_step_s": sum(e - b for b, e in spans[1:]),
        "rounds": rounds,
        "round_s_total": sum(r["seconds"] for r in rounds),
        "round_tolerance": tol,
        "examples_per_s": eps,
        "examples_per_s_without_evaluation": job_rec["examples_per_s"],
        "with_over_without": eps / job_rec["examples_per_s"],
    })
    del job, jobs

    # 2. evaluation-only: labels planted from the final checkpoint's own
    # predictions (the first half right, the second half off by one)
    final = os.path.join(ckpt_dir, "ckpt_v%d" % steps)
    params, state = _checkpoint_weights(torch, final)
    direct_out = _direct_forward(torch, params, state, images)
    pred = direct_out.argmax(1).cpu().numpy()
    half = EVAL_RECORDS // 2
    planted = np.concatenate([pred[:half], (pred[half:] + 1) % JOB_CLASSES])
    planted_dir = os.path.join(tmp, "eval-planted")
    write_records(planted_dir, images, planted + 1)
    zoo_dir = os.path.join(REPO, "elasticdl_tpu_torch", "model_zoo")
    records = {}
    for source, flag, value in (
        ("checkpoint", "--checkpoint_dir", ckpt_dir),
        ("export", "--checkpoint_filename_for_init",
         os.path.join(out_dir, sorted(os.listdir(out_dir))[-1])),
    ):
        job, wall, run_s, task_s = _scoring_job(
            torch, serving_argv("evaluate", "--validation_data", planted_dir,
                                flag, value, zoo_dir),
            "evaluate from the " + source,
        )
        got = job.master.evaluation_service.published
        if source == "checkpoint":
            want = 0.5
        else:
            e_params, e_state = _export_weights(torch, value)
            want = _accuracy(torch, _direct_forward(
                torch, e_params, e_state, images), planted + 1)
        acc = got[0]["metrics"]["accuracy"] if len(got) == 1 else None
        if acc is None or abs(acc - want) > tol + 1e-12:
            problems.append("evaluate from the %s reads %s, expected %s"
                            % (source, got, want))
        records[source] = rec = {
            "phase": "eval",
            "of": "evaluate_" + source,
            "card": card,
            "accuracy": acc,
            "expected": want,
            "tolerance": tol,
            "scored_versions": got[0]["scored_versions"] if got else None,
            "job_s": wall,
            "worker_run_s": run_s,
            "task_s": task_s,
            "examples_per_s": EVAL_RECORDS / sum(task_s),
            "examples_per_s_job": EVAL_RECORDS / wall,
        }
        emit(rec)
        del job
    # the checkpoint's evaluation-only job once more, profiled: where its
    # wall goes (the load, the forwards, the drain's empty polls)
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    with prof:
        _scoring_job(
            torch, serving_argv("evaluate", "--validation_data", planted_dir,
                                "--checkpoint_dir", ckpt_dir, zoo_dir),
            "evaluate (profiled)",
        )
    emit(dict(
        _window_record(torch, prof, (time.perf_counter() - t0) * 1e3),
        phase="profile", of="evaluate_checkpoint", card=card,
    ))

    # 3. prediction-only with a capturing processor installed on the zoo
    # module (the job resolves it through the port's zoo package)
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
        BasePredictionOutputsProcessor,
    )

    class Capture(BasePredictionOutputsProcessor):
        def __init__(self):
            self.chunks = []

        def process(self, predictions, worker_id):
            self.chunks.append(np.asarray(predictions))

    capture = Capture()
    handed = []
    orig_get = MasterServicer.get_task

    def get_task(servicer, worker_id, task_type=None):
        res = orig_get(servicer, worker_id, task_type)
        if res.shard_name:
            handed.append((res.start, res.end))
        return res

    zoo.PredictionOutputsProcessor = capture
    MasterServicer.get_task = get_task
    try:
        job, wall, run_s, _ = _scoring_job(
            torch, serving_argv("predict", "--prediction_data", val_dir,
                                "--checkpoint_dir", ckpt_dir, ""),
            "predict",
        )
    finally:
        MasterServicer.get_task = orig_get
        del zoo.PredictionOutputsProcessor
    order = [i for start, end in handed for i in range(start, end)]
    got = np.concatenate(capture.chunks) if capture.chunks else np.zeros(0)
    once = sorted(order) == list(range(EVAL_RECORDS)) and len(got) == len(
        order)
    rel = None
    if once:
        want = direct_out[torch.as_tensor(order, device=direct_out.device)]
        rel = _rel_l2(torch, torch.from_numpy(got).to(want.device), want)
    if not once or rel > EVAL_REL_L2:
        problems.append("predict: records %s (%d rows), rel L2 %s"
                        % (handed, len(got), rel))
    emit({
        "phase": "eval",
        "of": "predict",
        "card": card,
        "records": len(got),
        "every_record_once": once,
        "rel_l2": rel,
        "rel_l2_limit": EVAL_REL_L2,
        "job_s": wall,
        "worker_run_s": run_s,
        "examples_per_s": EVAL_RECORDS / run_s,
        "examples_per_s_job": EVAL_RECORDS / wall,
    })
    counts = _counts()
    if problems:
        raise PhaseError("eval: " + "; ".join(problems))
    return counts


def _record_at(records, kernel, key):
    b, lq, lk, h, d, dtype, causal = key
    return next(
        r for r in records
        if r["kernel"] == kernel
        and r["shape"] == [b, lq, h, d]
        and r["lk"] == lk
        and r["dtype"] == dtype
        and r["causal"] == causal
        and "kernel_ms" in r
    )


def kernels_line(records, paths):
    """The contract line: each kernel with its launches summed over the
    main paths (``paths``: {path: counts}), at the shape those paths
    launched it at most, with that shape's checked record."""
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        by_path = {path: c[name][0] for path, c in paths.items()}
        shapes = {}
        for c in paths.values():
            for key, n in c[name][1].items():
                shapes[key] = shapes.get(key, 0) + n
        key = max(shapes, key=shapes.get)
        rec = _record_at(records, name, key)
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "shape": rec["shape"],
                "dtype": rec["dtype"],
                "causal": rec["causal"],
                "max_abs_err": rec["max_abs_err"],
                "rel_l2": rec["rel_l2"],
                "ms": rec["kernel_ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                "device_ms": rec.get("kernel_device_ms"),
                "library_device_ms": rec.get("library_device_ms"),
                "checked_cases": sum(1 for r in records if r["kernel"] == name),
                "ok": True,
            }
        )
    return {"kernels": kernels}


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv
    )
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing to check",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "elasticdl_tpu_torch")):
        print(
            "chip_smoke: run from a checkout of the repository "
            "(elasticdl_tpu_torch/ not found beside this script)",
            file=sys.stderr,
        )
        return 2
    sys.path.insert(0, REPO)

    try:
        card = phase_device(torch)
        phase_build()
        records = phase_kernels(torch)
        records += phase_bwd_kernels(torch)
        phase_bwd_memory(torch)
        with tempfile.TemporaryDirectory() as tmp:
            served = phase_slice(torch, tmp)
        trained = phase_train(torch)
        fused = phase_fused_step(torch, card)
        with tempfile.TemporaryDirectory() as tmp:
            job, job_rec = phase_job(torch, tmp, fused, card)
            _check_counts(job, {k: 0 for k in KERNELS}, "the ResNet-50 job")
            evaluated = phase_eval(torch, tmp, job_rec, card)
        _check_counts(evaluated, {k: 0 for k in KERNELS}, "the eval phase")
        line = kernels_line(
            records,
            {"serve": served, "train": trained, "job": job,
             "eval": evaluated},
        )
    except Exception as err:  # noqa: BLE001 — reported, exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED: %s" % err, file=sys.stderr)
        return 1
    emit(line)
    print(card)
    # the result line, keys in the contract's order
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
