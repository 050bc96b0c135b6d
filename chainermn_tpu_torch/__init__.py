"""chainermn_tpu_torch: the PyTorch/CUDA port of chainermn_tpu for NVIDIA Hopper.

A second package beside ``chainermn_tpu`` (the JAX reference, which it never
imports).  It mirrors the JAX package's layout and public names; every
Pallas kernel on a ported path is a hand-written CUDA kernel here
(``csrc/``), each beside a plain PyTorch version that CPU tensors take.

Ported so far (one card, or one process per card for data parallelism):

* ``ops``: flash-attention forward and backward, decode attention, the
  beam/GQA attention kernel, KV-cache append, fused cross-entropy (stats,
  dh, dtable), the conv backward (wgrad, dgrad) behind ``ops.conv2d``;
* ``parallel``: tensor-parallel layers at world 1, the LM (layer norm,
  RoPE, QKV, GQA), its training step, greedy / sampled / beam decoding;
* ``serving``: scheduler, slot pool, decode engine, ``ServingEngine``;
* ``prng``: threefry ``PRNGKey`` / ``fold_in`` / ``uniform`` bit for bit;
* data-parallel training: ``topology`` (process group, rank topology),
  ``communicators`` (``create_communicator``: NCCL / gloo, the naive
  oracle), ``optimizers`` (``create_multi_node_optimizer``: bucketed
  gradient mean, bf16 wire, double buffering), ``train``
  (``make_train_step``, ``make_flax_train_step``, ``shard_batch``),
  ``models`` (the ResNets with flax's BatchNorm, the MLP), ``datasets``
  (``scatter_dataset``), ``runtime`` (the native prefetcher);
* ``convert``: JAX params → port params (the LM, ``resnet_from_jax``), npz;
* CLIs: ``serve``, ``train_transformer``, ``train_imagenet``.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.  Submodules are imported on use: importing this package
imports nothing else.
"""

__all__ = ["communicators", "convert", "datasets", "models", "observability",
           "ops", "optimizers", "parallel", "prng", "runtime", "serving",
           "topology", "train"]
