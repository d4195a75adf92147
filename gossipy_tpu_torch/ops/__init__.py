"""Hand-written kernels and their plain PyTorch versions."""

from . import attention, merge
from ._build import LAUNCHES, reset_launch_counts
from .attention import (flash_attention, flash_attention_reference,
                        flash_hop_update, flash_hop_update_cuda,
                        flash_hop_update_reference,
                        flash_hop_update_split_reference,
                        flash_hop_update_tf32_reference, hop_schedule,
                        hop_update_reference, tf32_split,
                        tf32_split_reference)
from .merge import (column_leaves, gather_merge_flat, gather_merge_flat_cuda,
                    gather_merge_multi, gather_merge_multi_cuda,
                    gather_merge_multi_dq_cuda, gather_merge_multi_pytree,
                    gather_merge_multi_reference, gather_merge_pytree,
                    gather_merge_reference)

# Every CUDA source of the package (csrc/<name>.cu), as _build.build takes
# them.
SOURCES = sorted(set(merge.SOURCES.values()) | set(attention.SOURCES.values()))

__all__ = ["LAUNCHES", "SOURCES", "column_leaves", "flash_attention",
           "flash_attention_reference", "flash_hop_update",
           "flash_hop_update_cuda", "flash_hop_update_reference",
           "flash_hop_update_split_reference",
           "flash_hop_update_tf32_reference",
           "gather_merge_flat", "gather_merge_flat_cuda",
           "gather_merge_multi", "gather_merge_multi_cuda",
           "gather_merge_multi_dq_cuda", "gather_merge_multi_pytree",
           "gather_merge_multi_reference", "gather_merge_pytree",
           "gather_merge_reference", "hop_schedule", "hop_update_reference",
           "reset_launch_counts", "tf32_split", "tf32_split_reference"]
