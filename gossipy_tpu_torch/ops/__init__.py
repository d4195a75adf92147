"""Hand-written kernels and their plain PyTorch versions."""

from .merge import (LAUNCHES, column_leaves, gather_merge_flat,
                    gather_merge_flat_cuda, gather_merge_multi,
                    gather_merge_multi_cuda, gather_merge_multi_dq_cuda,
                    gather_merge_multi_pytree, gather_merge_multi_reference,
                    gather_merge_pytree, gather_merge_reference,
                    reset_launch_counts)

__all__ = ["LAUNCHES", "column_leaves", "gather_merge_flat",
           "gather_merge_flat_cuda", "gather_merge_multi",
           "gather_merge_multi_cuda", "gather_merge_multi_dq_cuda",
           "gather_merge_multi_pytree", "gather_merge_multi_reference",
           "gather_merge_pytree", "gather_merge_reference",
           "reset_launch_counts"]
