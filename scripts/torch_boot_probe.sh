#!/usr/bin/env bash
# What a fresh Python process pays to start torch on this machine: the
# bytecode settings, whether torch ships compiled bytecode, and the
# seconds of `import torch` and of the first optimizer step (which
# imports torch._dynamo), twice as the machine runs Python and twice
# with a PYTHONPYCACHEPREFIX alone. With -X importtime, the slowest
# imports of the first two runs go to OUT (default ./boot_probe).
#
#   bash scripts/torch_boot_probe.sh [OUT]
set -u
OUT=${1:-boot_probe}
mkdir -p "$OUT"
python3 -c "import sys, os, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.__file__, 'dont_write', sys.flags.dont_write_bytecode, os.environ.get('PYTHONDONTWRITEBYTECODE'), os.environ.get('PYTHONPYCACHEPREFIX'))"
TD=$(python3 -c "import torch, os; print(os.path.dirname(torch.__file__))")
ls -ld "$TD/_dynamo" "$TD/_dynamo/__pycache__" 2>&1 | head
python3 -c "import triton; print('triton', triton.__version__)" 2>&1 | tail -1
nproc
S='import time; t0=time.time(); import torch; t1=time.time(); torch.optim.SGD([torch.zeros(1,requires_grad=True)],lr=0.1).step(); t2=time.time(); print("import_torch %.2f first_step %.2f" % (t1-t0, t2-t1))'
for i in 1 2; do python3 -X importtime -c "$S" 2> "$OUT/importtime_$i.txt"; done
export PYTHONPYCACHEPREFIX=$PWD/$OUT/pycache_prefix
for i in 1 2; do python3 -c "$S"; done
rm -rf "$PWD/$OUT/pycache_prefix"
for i in 1 2; do sort -t'|' -k2 -n "$OUT/importtime_$i.txt" | tail -25 | cut -c1-120; echo; done
