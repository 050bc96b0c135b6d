"""Model-parallel and synchronized links (reference: ``chainermn/links/``).

Counterpart of ``chainermn_tpu/links/``: ``MultiNodeChainList`` and
``MultiNodeBatchNormalization``.
"""

from .multi_node_batch_normalization import MultiNodeBatchNormalization
from .multi_node_chain_list import MultiNodeChainList

__all__ = ["MultiNodeBatchNormalization", "MultiNodeChainList"]
