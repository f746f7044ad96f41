"""elasticdl_tpu_torch: the PyTorch/CUDA port of elasticdl_tpu.

A second package beside the JAX one, held against it by the
``tests/test_torch_*.py`` parity tests. It imports nothing of JAX and
nothing of ``elasticdl_tpu`` or ``model_zoo``. Where the JAX package runs
a Pallas TPU kernel, the port runs a kernel written by hand for Hopper
(``ops/csrc``), with a plain PyTorch twin beside it for the CPU.

Ported so far, for ``transformer_lm``: the serving path — export
artifacts (``common/export.py``), the model (``model_zoo``), the scorer,
micro-batcher and RPC server (``serving``, ``rpc``) — and the training
path on one device — ``parallel/trainer.AllReduceTrainer``, the step
builders (``training``), the model interface (``nn``) and the record
and dataset modules (``data``) — over flash attention's forward and
backward kernels (``ops``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
