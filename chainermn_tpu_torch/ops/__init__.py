"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper takes its plain version for a CPU tensor and launches its
CUDA kernel for a CUDA tensor (or raises); each counts its launches in a
plain integer attribute, ``<wrapper>.launches``.
"""

from .conv_backward import (conv2d, conv3x3_dgrad, conv3x3_dgrad_plain,
                            conv3x3_wgrad, conv3x3_wgrad_plain)
from .decode_attention import (beam_attend_parts, beam_attend_parts_plain,
                               decode_attend, decode_attend_gqa,
                               decode_attend_plain, merge_attend_parts)
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_plain, flash_attention_plain,
                              resolve_attn_impl)
from .fused_ce import (ce_dh, ce_dh_plain, ce_dtable, ce_dtable_plain,
                       ce_grads, ce_grads_plain, ce_stats, ce_stats_plain,
                       fused_cross_entropy)
from .kv_cache import cache_append, cache_append_plain

KERNEL_WRAPPERS = {
    "flash_fwd": flash_attention,
    "flash_bwd": flash_attention_bwd,
    "decode_attend": decode_attend,
    "cache_append": cache_append,
    "ce_stats": ce_stats,
    "ce_dh": ce_dh,
    "ce_dtable": ce_dtable,
    "beam_attend": beam_attend_parts,
    "conv_wgrad": conv3x3_wgrad,
    "conv_dgrad": conv3x3_dgrad,
}


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the last reset."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["beam_attend_parts", "beam_attend_parts_plain",
           "cache_append", "cache_append_plain", "ce_dh", "ce_dh_plain",
           "ce_dtable", "ce_dtable_plain", "ce_grads", "ce_grads_plain",
           "ce_stats", "ce_stats_plain", "conv2d", "conv3x3_dgrad",
           "conv3x3_dgrad_plain", "conv3x3_wgrad", "conv3x3_wgrad_plain",
           "decode_attend", "decode_attend_gqa", "decode_attend_plain",
           "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_plain", "fused_cross_entropy",
           "KERNEL_WRAPPERS", "launch_counts", "merge_attend_parts",
           "reset_launch_counts", "resolve_attn_impl"]
