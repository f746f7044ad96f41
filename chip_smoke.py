#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``elasticdl_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. device  — the card, its power limit, the CUDA toolkit.
2. build   — every kernel under ``elasticdl_tpu_torch/ops/csrc`` built
   from source with nvcc for sm_90a, all at once (ptxas report printed).
3. kernels — each kernel against its plain PyTorch version on the card,
   at the listed shapes, with times, the bound and the library yardstick.
4. slice   — the 110M transformer LM (bf16, random weights from a seed)
   exported, then served through the scorer's entry points
   (build_scorer -> ScorerServicer -> MicroBatcher -> Scorer) on
   concurrent 1024-token requests. Replies are checked against solo
   scoring and against the model with attention swapped for the plain
   version; kernel launches are counted over the served requests alone.
   Then a torch.profiler breakdown of one batched forward.
5. summary — the kernels line, the card line, then the result line.

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
TOL = {  # dtype -> (rtol, atol) against the plain version in float32
    "float32": (2e-4, 2e-5),
    "bfloat16": (0.0, 2e-2),
}

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

FLASH_SOURCE = "elasticdl_tpu_torch/ops/csrc/flash_fwd.cu"
FLASH_REPLACES = "elasticdl_tpu/ops/flash_attention.py:39"


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


def phase_build():
    from elasticdl_tpu_torch.ops import build

    t0 = time.perf_counter()
    built = build.build_all()
    emit(
        {
            "phase": "build",
            "seconds": time.perf_counter() - t0,
            "libraries": {s: os.path.basename(p) for s, p in built.items()},
        }
    )
    for source, log in sorted(build.build_logs.items()):
        print("ptxas report for %s:" % source)
        print(log.strip())


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


def flash_bound(b, h, d, lq, lk, dtype, causal):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (q, k, v read once, out and lse written once) over HBM
    bandwidth and its two matrix products over the dtype's peak rate.
    Causal work counts only the visible (query, key) pairs."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * lq * h * d + 2 * b * lk * h * d) * elem + b * h * lq * 4
    if causal:
        pairs = sum(min(i + 1, lk) for i in range(lq))
    else:
        pairs = lq * lk
    ops = 4.0 * b * h * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def check_flash_case(torch, b, h, d, l, dtype, causal, seed):
    from elasticdl_tpu_torch.ops import flash_attention as fa

    tdtype = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (
        torch.randn(
            (b, l, h, d), generator=gen, device="cuda", dtype=torch.float32
        ).to(tdtype)
        for _ in range(3)
    )
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.plain_flash_with_lse(
        q.float(), k.float(), v.float(), causal
    )
    rtol, atol = TOL[dtype]
    err_out = (out.float() - ref_out).abs()
    err_lse = (lse - ref_lse).abs()
    ok = bool(
        torch.isfinite(out).all()
        and (err_out <= atol + rtol * ref_out.abs()).all()
        and (err_lse <= atol + rtol * ref_lse.abs()).all()
    )
    bound_ms, bound_by = flash_bound(b, h, d, l, l, dtype, causal)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rec = {
        "phase": "kernels",
        "kernel": "flash_fwd",
        "shape": [b, l, h, d],
        "dtype": dtype,
        "causal": causal,
        "max_abs_err": float(err_out.max()),
        "max_abs_err_lse": float(err_lse.max()),
        "rtol": rtol,
        "atol": atol,
        "ok": ok,
        "bound_ms": bound_ms,
        "bound_us": bound_ms * 1e3,
        "bound_by": bound_by,
        "kernel_ms": time_ms(
            torch, lambda: fa.flash_attention_with_lse(q, k, v, causal), 50
        ),
        "plain_ms": time_ms(
            torch, lambda: fa.plain_flash_with_lse(q, k, v, causal), 5, 1
        ),
        "library_ms": time_ms(
            torch, lambda: sdpa(qt, kt, vt, is_causal=causal), 50
        ),
    }
    emit(rec)
    if not ok:
        raise PhaseError(
            "flash_fwd disagrees with its plain version at %s" % rec
        )
    return rec


def phase_kernels(torch):
    """Every (shape, dtype, causal) case; returns the records."""
    records = []
    seed = 0
    for b, h, d, l in KERNEL_SHAPES:
        for dtype in ("float32", "bfloat16"):
            for causal in (False, True):
                seed += 1
                records.append(
                    check_flash_case(torch, b, h, d, l, dtype, causal, seed)
                )
    return records


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


def _profile_forward(torch, model, tokens):
    """Device time by kernel over one batched forward (torch.profiler);
    an empty breakdown says the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model({"tokens": tokens})
        torch.cuda.synchronize()
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            model({"tokens": tokens})
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        # device-side events only: a CPU op's device total repeats the
        # time of the kernels it launched
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    emit(
        {
            "phase": "profile",
            "rows": int(tokens.shape[0]),
            "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "idle_share": (1 - busy_ms / wall_ms) if rows else None,
            "top": [
                {"kernel": k[:90], "ms": us / 1e3, "calls": n}
                for us, k, n in rows[:12]
            ],
        }
    )


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
        fa.launches.reset()
        replies, latency, wall = _fire(servicer, requests)
        launches = fa.launches.count
        shapes = fa.launches.shapes()
        forwards = int(ok.value(outcome="ok") - forwards0)
        forward_s = _forward_seconds() - forward_s0
        peak = torch.cuda.max_memory_allocated()
    finally:
        batcher.stop(drain=True)
        batcher.close()
    for i, reply in enumerate(replies):
        _check_reply(torch, reply, i)
    layers = SLICE_CFG["num_layers"]
    if forwards < 1 or launches != layers * forwards:
        raise PhaseError(
            "flash_fwd launched %d times over %d forwards; expected %d "
            "per forward" % (launches, forwards, layers)
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
    return {"launches": launches, "shapes": shapes}


def kernels_line(torch, records, served):
    """The contract line: each kernel at the shape the main path
    launched it at most, with its launches from that run."""
    shape, _ = max(served["shapes"].items(), key=lambda kv: kv[1])
    b, lq, _lk, h, d, dtype, causal = shape
    rec = next(
        (
            r for r in records
            if r["shape"] == [b, lq, h, d]
            and r["dtype"] == dtype
            and r["causal"] == causal
        ),
        None,
    )
    if rec is None:
        rec = check_flash_case(torch, b, h, d, lq, dtype, causal, 1000)
    return {
        "kernels": [
            {
                "name": "flash_fwd",
                "route": "cuda",
                "source": FLASH_SOURCE,
                "replaces": FLASH_REPLACES,
                "launches": served["launches"],
                "shape": [b, lq, h, d],
                "dtype": dtype,
                "causal": causal,
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["kernel_ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                "checked_cases": len(records),
                "ok": True,
            }
        ]
    }


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        card = phase_device(torch)
        phase_build()
        records = phase_kernels(torch)
        with tempfile.TemporaryDirectory() as tmp:
            served = phase_slice(torch, tmp)
        line = kernels_line(torch, records, served)
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
