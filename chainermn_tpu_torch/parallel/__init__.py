"""Model layers and decoding (TP = 1 on one card in this slice)."""

from .decode import (lm_decode_tick, lm_generate, lm_prefill,
                     make_lm_generator)
from .tensor_parallel import (column_parallel_dense, row_parallel_dense,
                              tp_mlp, vocab_parallel_embedding)
from .transformer import apply_rope, init_tp_transformer_lm

__all__ = ["apply_rope", "column_parallel_dense", "init_tp_transformer_lm",
           "lm_decode_tick", "lm_generate", "lm_prefill", "make_lm_generator",
           "row_parallel_dense", "tp_mlp", "vocab_parallel_embedding"]
