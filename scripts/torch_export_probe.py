"""Probe of ``torch.export`` on the card, for the serving member
(``elasticdl_tpu_torch/common/export.py``): run it from the root of a
checkout on a machine with one CUDA card,

    python3 scripts/torch_export_probe.py

It prints the Python, torch and CUDA versions, the card's name and power
limit, then one JSON line:

- a 2-layer transformer LM (bf16, seq 1024, so the flash branch) on the
  card, exported with a dynamic batch dimension: the export's seconds,
  whether the graph holds the registered ``flash_fwd`` op, and, after
  ``torch.export.save`` and ``load``, its answers at batch 1 and 3
  against the module's with the flash launches of each call;
- the same weights traced on the CPU and moved to the card with
  ``move_to_device_pass``, and the card-traced one moved to the CPU;
- ResNet-50 (the zoo's, 1000 classes, uninitialized weights) on the
  card: the export's seconds and its save and load's.

The first export of the process pays torch.export's own start-up.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

print("versions", sys.version.split()[0], torch.__version__,
      torch.version.cuda, flush=True)
print(subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout, flush=True)

from torch.export import Dim  # noqa: E402

from elasticdl_tpu_torch.model_zoo.transformer_lm.transformer_lm import (  # noqa: E402,E501
    TransformerLM,
    init_parameters,
)
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402

res = {}
out_dir = tempfile.mkdtemp(prefix="export-probe-")


def export(m, feats):
    b = Dim("batch", min=1)
    spec = ({k: {0: b} for k in feats},)
    t = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(m, (feats,), dynamic_shapes=spec)
    return ep, time.perf_counter() - t


def lm(device):
    return TransformerLM(vocab_size=512, num_layers=2, num_heads=2,
                         head_dim=64, embed_dim=128, mlp_dim=256,
                         dtype=torch.bfloat16).to(device).eval()


try:
    torch.manual_seed(0)
    m = lm("cuda")
    init_parameters(m, torch.Generator(device="cuda").manual_seed(0))
    ex = {"tokens": torch.randint(0, 512, (2, 1024), dtype=torch.int32,
                                  device="cuda")}
    ep, s = export(m, ex)
    res["lm_export_s"] = s
    res["has_op"] = any("flash_fwd" in str(n.target) for n in ep.graph.nodes)
    torch.export.save(ep, os.path.join(out_dir, "lm.pt2"))
    prog = torch.export.load(os.path.join(out_dir, "lm.pt2")).module()
    for n in (1, 3):
        x = {"tokens": torch.randint(0, 512, (n, 1024), dtype=torch.int32,
                                     device="cuda")}
        fa.launches.reset()
        with torch.no_grad():
            got = prog(x)
        launches = fa.launches.count
        with torch.no_grad():
            want = m(x)
        torch.cuda.synchronize()
        res["lm_b%d" % n] = dict(
            launches=launches,
            err=float((got.float() - want.float()).abs().max()),
            dtype=str(got.dtype))
    # traced on the CPU, served on the card
    mc = lm("cpu")
    mc.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    epc, s = export(mc, {"tokens": ex["tokens"].cpu()})
    res["lm_cpu_export_s"] = s
    torch.export.save(epc, os.path.join(out_dir, "lmc.pt2"))
    from torch.export.passes import move_to_device_pass

    epg = move_to_device_pass(
        torch.export.load(os.path.join(out_dir, "lmc.pt2")), "cuda")
    x = {"tokens": torch.randint(0, 512, (3, 1024), dtype=torch.int32,
                                 device="cuda")}
    fa.launches.reset()
    with torch.no_grad():
        got = epg.module()(x)
    launches = fa.launches.count
    with torch.no_grad():
        want = m(x)
    res["cpu_to_cuda"] = dict(
        launches=launches, err=float((got.float() - want.float()).abs().max()),
        device=str(got.device))
    # traced on the card, served on the CPU
    epb = move_to_device_pass(
        torch.export.load(os.path.join(out_dir, "lm.pt2")), "cpu")
    with torch.no_grad():
        got = epb.module()({"tokens": x["tokens"].cpu()})
    res["cuda_to_cpu"] = dict(
        err=float((got.float() - want.float().cpu()).abs().max()),
        device=str(got.device))
except Exception as e:  # noqa: BLE001 - reported in the JSON line
    import traceback

    traceback.print_exc()
    res["error"] = repr(e)
try:
    from elasticdl_tpu_torch.model_zoo.imagenet_resnet50 import (
        imagenet_resnet50 as rz,
    )

    rm = rz.custom_model().cuda().eval()
    ex = {"image": torch.randint(0, 255, (2, 224, 224, 3), dtype=torch.uint8,
                                 device="cuda")}
    ep, s = export(rm, ex)
    res["resnet_export_s"] = s
    t = time.perf_counter()
    torch.export.save(ep, os.path.join(out_dir, "rn.pt2"))
    prog = torch.export.load(os.path.join(out_dir, "rn.pt2")).module()
    res["resnet_saveload_s"] = time.perf_counter() - t
except Exception as e:  # noqa: BLE001 - reported in the JSON line
    import traceback

    traceback.print_exc()
    res["resnet_error"] = repr(e)
print(json.dumps(res), flush=True)
