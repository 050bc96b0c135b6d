"""Model layers over a ('data', 'model') mesh (tensor and sequence
parallelism, the collective matmuls), the strategies along one mesh axis
(ring attention, Ulysses, the sequence-sharded LM, the MoE layer, the
GPipe and 1F1B pipelines), the training steps (hybrid DP x TP, ZeRO-1,
FSDP), decoding, and the array redistribution of ``reshard``."""

from ._factory import P, PartitionSpec, make_global_apply
from .collective_matmul import (all_gather_matmul, make_all_gather_matmul,
                                make_matmul_reduce_scatter,
                                matmul_reduce_scatter)
from .decode import (lm_decode_tick, lm_generate, lm_generate_beam,
                     lm_prefill, make_lm_beam_generator, make_lm_generator)
from .hybrid import (init_fsdp_params, init_fsdp_state, init_zero1_state,
                     make_fsdp_train_step, make_hybrid_shard_map_step,
                     make_hybrid_train_step, make_zero1_train_step,
                     param_leaves, shard_pytree, state_specs_like,
                     zero1_specs)
from .moe import init_moe_mlp_params, make_moe_mlp, moe_mlp, moe_mlp_specs
from .pipeline import (make_pipeline, make_pipeline_1f1b,
                       pipeline_1f1b_grads, pipeline_apply,
                       stack_stage_params)
from .reshard import (make_reshard, reshard, reshard_cost, reshard_host,
                      reshard_tree_cost)
from .ring_attention import make_ring_attention, ring_attention
from .tensor_parallel import (column_parallel_dense, gather_seq_matmul,
                              init_tp_mlp_params, make_tensor_parallel_mlp,
                              matmul_scatter_seq, row_parallel_dense, tp_mlp,
                              tp_mlp_sp, tp_mlp_specs,
                              vocab_parallel_embedding)
from .transformer import (apply_rope, init_tp_transformer_lm, sp_block,
                          sp_transformer_lm_loss, tp_attention,
                          tp_attention_sp, tp_block, tp_block_sp,
                          tp_transformer_lm_loss, transformer_lm_specs,
                          vocab_parallel_logits_loss)
from .ulysses import make_ulysses_attention, ulysses_attention

__all__ = ["all_gather_matmul", "apply_rope", "column_parallel_dense",
           "gather_seq_matmul", "init_fsdp_params", "init_fsdp_state",
           "init_moe_mlp_params", "init_tp_mlp_params",
           "init_tp_transformer_lm", "init_zero1_state", "lm_decode_tick",
           "lm_generate", "lm_generate_beam", "lm_prefill",
           "make_all_gather_matmul", "make_fsdp_train_step",
           "make_global_apply", "make_hybrid_shard_map_step",
           "make_hybrid_train_step", "make_zero1_train_step", "make_lm_beam_generator",
           "make_lm_generator", "make_matmul_reduce_scatter", "make_moe_mlp",
           "make_pipeline", "make_pipeline_1f1b", "make_reshard",
           "make_ring_attention", "make_tensor_parallel_mlp",
           "make_ulysses_attention", "matmul_reduce_scatter",
           "matmul_scatter_seq", "moe_mlp", "moe_mlp_specs", "P",
           "param_leaves", "PartitionSpec", "pipeline_1f1b_grads",
           "pipeline_apply", "reshard", "reshard_cost", "reshard_host",
           "reshard_tree_cost", "ring_attention", "row_parallel_dense",
           "shard_pytree", "sp_block", "sp_transformer_lm_loss",
           "stack_stage_params", "state_specs_like", "tp_attention",
           "tp_attention_sp", "tp_block", "tp_block_sp", "tp_mlp",
           "tp_mlp_sp", "tp_mlp_specs", "tp_transformer_lm_loss",
           "transformer_lm_specs", "ulysses_attention",
           "vocab_parallel_embedding", "vocab_parallel_logits_loss",
           "zero1_specs"]
