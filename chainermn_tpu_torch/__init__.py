"""chainermn_tpu_torch: the PyTorch/CUDA port of chainermn_tpu for NVIDIA Hopper.

A second package beside ``chainermn_tpu`` (the JAX reference, which it never
imports).  It mirrors the JAX package's layout and public names; every
Pallas kernel on a ported path is a hand-written CUDA kernel here
(``csrc/``), each beside a plain PyTorch version that CPU tensors take.

Ported so far (serving, TP = 1 on one card):

* ``parallel``: tensor-parallel layers at world 1, the LM's layer norm,
  RoPE, QKV projection and init, greedy KV-cache decoding;
* ``ops``: flash-attention forward, decode attention, KV-cache append;
* ``serving``: scheduler, slot pool, decode engine, ``ServingEngine``;
* ``convert``: JAX params → port params, npz files;
* ``serve``: the serving CLI (``python -m chainermn_tpu_torch.serve``).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.  Submodules are imported on use: importing this package
imports nothing else.
"""

__all__ = ["convert", "observability", "ops", "parallel", "serving"]
