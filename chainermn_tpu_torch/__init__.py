"""chainermn_tpu_torch: the PyTorch/CUDA port of chainermn_tpu for NVIDIA Hopper.

A second package beside ``chainermn_tpu`` (the JAX reference, which it never
imports).  It mirrors the JAX package's layout and public names; every
Pallas kernel on a ported path is a hand-written CUDA kernel here
(``csrc/``), each beside a plain PyTorch version that CPU tensors take.

Ported so far (one process per card: one card, data parallelism, and
the LM's tensor and data parallelism over a ``('data', 'model')`` mesh):

* ``ops``: flash-attention forward and backward, decode attention, the
  beam/GQA attention kernel, KV-cache append, fused cross-entropy (stats,
  dh, dtable), the conv backward (wgrad, dgrad) behind ``ops.conv2d``;
* ``parallel``: tensor- and sequence-parallel layers over a ``('data',
  'model')`` mesh (``topology.make_nd_mesh``, ``make_multislice_mesh``,
  ``slice_index_of``), the collective matmuls, the
  LM (layer norm, RoPE, QKV, GQA, the vocab-parallel loss), the hybrid
  DP x TP training step, ZeRO-1 and FSDP over the data axis, greedy /
  sampled / beam decoding at any TP width;
  the strategies along one mesh axis: ring attention over the flash
  kernels (their LSE cotangent in the backward), Ulysses, the
  sequence-sharded LM, the MoE layer, the GPipe and 1F1B pipelines;
* ``serving``: scheduler, slot pool, decode engine, ``ServingEngine``
  (at TP > 1: model rank 0 leads, the others follow its plan);
* ``prng``: threefry ``PRNGKey`` / ``fold_in`` / ``uniform`` bit for bit;
* data-parallel training: ``topology`` (process group, rank topology),
  ``communicators`` (``create_communicator``: NCCL / gloo, the naive
  oracle; every array and object collective, ``split``),
  ``ops.collective`` (the in-step collectives, the block-scaled int8
  ring, the hierarchical mean), ``optimizers``
  (``create_multi_node_optimizer``: bucketed gradient mean, bf16 / fp16 /
  int8 wire, error feedback, double buffering), ``train`` (``make_train_step`` with gradient
  accumulation, ``make_flax_train_step``, ``make_demo_step``,
  ``shard_batch``),
  ``models`` (the ResNets with flax's BatchNorm, stalebn or affine norms,
  the NF-ResNets, AlexNet / VGG-16 / GoogLeNet, ViT, the MLP), ``optim``
  (LARS, LAMB, adaptive gradient clipping, the linear warmup), ``datasets``
  (``scatter_dataset``), ``runtime`` (the native prefetcher);
* the Trainer stack: ``training`` (``Trainer``, ``StandardUpdater`` with
  the prefetch thread, triggers, LogReport / PrintReport / StepTimer /
  TorchProfiler / EvaluatorExtension / snapshot), ``iterators``
  (``SerialIterator``, the multi-node and synchronized iterators),
  ``evaluators`` (the multi-node evaluator, BLEU), ``extensions`` (the
  observation aggregator, ``AllreducePersistent``),
  ``observability.trace`` (the span tracer);
* training robustness: ``extensions`` (``MultiNodeCheckpointer`` with v2
  manifests and elastic resume, ``multi_node_snapshot``, the preemption
  handler, the watchdog, the self-healing gang), ``health`` (leases,
  epoch fences, membership consensus, the collective guard),
  ``global_except_hook``, ``parallel.reshard``, the communicator's object
  lanes, ``observability.flight`` (the flight recorder) and
  ``observability.export.health_snapshot``;
* model parallelism: ``functions`` (differentiable collectives, send /
  recv, ``pseudo_connect``), ``links`` (``MultiNodeChainList``,
  ``MultiNodeBatchNormalization``); ``models.seq2seq`` (the LSTM
  encoder-decoder);
* ``convert``: JAX params → port params (the LM, its shards on a mesh
  with ``shard_from_jax`` and back with ``gather_to_numpy``, ``resnet_from_jax`` and
  its twins for the NF-ResNets, the convnets and ViT, ``mlp_from_jax``,
  ``seq2seq_from_jax``, the demo step's), npz;
* CLIs: ``serve`` and ``train_transformer`` (``--tp``), ``train_hybrid``,
  ``train_long_context`` (``--sp-impl ring|ulysses``), ``train_moe``,
  ``generate``, ``train_imagenet``, ``train``
  (the demo trainer), ``train_mnist`` (the MNIST example),
  ``train_seq2seq``, ``train_model_parallel`` and
  ``train_mnist_checkpoint`` (MNIST with checkpoints and resume).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.  Submodules are imported on use: importing this package
imports nothing else.  The JAX package's top-level names resolve on first
use (``import chainermn_tpu_torch as mn; mn.create_communicator(...)``)
through a module ``__getattr__``; a name not ported yet raises
``AttributeError`` naming its ROADMAP.md queue item.
"""

import importlib

__version__ = "0.1.0"

__all__ = ["communicators", "convert", "datasets", "evaluators", "extensions",
           "functions", "global_except_hook", "health", "iterators", "links",
           "models", "observability", "ops", "optim", "optimizers",
           "parallel", "prng", "runtime", "serving", "topology", "train",
           "training"]

# the JAX package's top-level names (chainermn_tpu/__init__.py) that the
# port has: name -> the submodule that holds it
_NAMES = {
    **dict.fromkeys(("FileDataset", "PrefetchIterator", "write_file_dataset"),
                    "runtime"),
    **dict.fromkeys(("column_parallel_dense", "row_parallel_dense", "tp_mlp",
                     "vocab_parallel_embedding", "make_tensor_parallel_mlp",
                     "tp_mlp_sp", "tp_block_sp", "tp_attention_sp",
                     "transformer_lm_specs", "shard_pytree",
                     "state_specs_like", "all_gather_matmul",
                     "matmul_reduce_scatter", "make_all_gather_matmul",
                     "make_matmul_reduce_scatter", "make_moe_mlp", "moe_mlp",
                     "make_pipeline", "pipeline_apply", "stack_stage_params",
                     "make_ring_attention", "ring_attention",
                     "make_ulysses_attention", "ulysses_attention"),
                    "parallel"),
    **dict.fromkeys(("AllreducePersistent", "ObservationAggregator",
                     "create_multi_node_checkpointer", "multi_node_snapshot"),
                    "extensions"),
    **dict.fromkeys(("SerialIterator", "create_multi_node_iterator",
                     "create_synchronized_iterator"), "iterators"),
    **dict.fromkeys(("ScatteredDataset", "SubDataset", "create_empty_dataset",
                     "scatter_dataset", "scatter_index"), "datasets"),
    **dict.fromkeys(("accuracy_evaluator", "bleu_evaluator", "corpus_bleu",
                     "create_multi_node_evaluator"), "evaluators"),
    **dict.fromkeys(("ErrorFeedbackState", "compressed_mean",
                     "create_multi_node_optimizer", "error_feedback_layout",
                     "fold_error_feedback", "gradient_average",
                     "hierarchical_gradient_average",
                     "opt_state_partition_specs"), "optimizers"),
    **dict.fromkeys(("make_flax_train_step", "make_train_step", "replicate",
                     "shard_batch", "shard_batch_local"), "train"),
    **dict.fromkeys(("CommunicatorBase", "NaiveCommunicator",
                     "XlaCommunicator", "create_communicator"),
                    "communicators"),
    **dict.fromkeys(("DEFAULT_AXIS_NAME", "Topology", "init_distributed",
                     "make_mesh", "make_nd_mesh", "make_multislice_mesh",
                     "slice_index_of"), "topology"),
}

# the JAX package's top-level names not ported yet: name -> ROADMAP.md
# queue A item (none now)
NOT_PORTED: dict = {}


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    if name in _NAMES:
        value = getattr(importlib.import_module(f".{_NAMES[name]}",
                                                __name__), name)
        globals()[name] = value
        return value
    if name in NOT_PORTED:
        raise AttributeError(
            f"chainermn_tpu_torch.{name} is not ported yet: see ROADMAP.md, "
            f"queue A, {NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__) | set(_NAMES))
