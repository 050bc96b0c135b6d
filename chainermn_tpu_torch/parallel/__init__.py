"""Model layers, the training step and decoding (TP = 1 on one card), and
the array redistribution of ``reshard``."""

from .decode import (lm_decode_tick, lm_generate, lm_generate_beam,
                     lm_prefill, make_lm_beam_generator, make_lm_generator)
from .hybrid import make_hybrid_shard_map_step, param_leaves
from .reshard import (make_reshard, reshard, reshard_cost, reshard_host,
                      reshard_tree_cost)
from .tensor_parallel import (column_parallel_dense, row_parallel_dense,
                              tp_mlp, vocab_parallel_embedding)
from .transformer import (apply_rope, init_tp_transformer_lm, tp_attention,
                          tp_block, tp_transformer_lm_loss,
                          vocab_parallel_logits_loss)

__all__ = ["apply_rope", "column_parallel_dense", "init_tp_transformer_lm",
           "lm_decode_tick", "lm_generate", "lm_generate_beam", "lm_prefill",
           "make_hybrid_shard_map_step", "make_lm_beam_generator",
           "make_lm_generator", "make_reshard", "param_leaves",
           "reshard", "reshard_cost", "reshard_host", "reshard_tree_cost",
           "row_parallel_dense", "tp_attention", "tp_block", "tp_mlp",
           "tp_transformer_lm_loss", "vocab_parallel_embedding",
           "vocab_parallel_logits_loss"]
