from repro_torch.utils.tree import (fmt_bytes, fmt_params, tree_add, tree_allclose, tree_bytes,
                                    tree_cast, tree_dot, tree_flatten_with_path, tree_leaves,
                                    tree_map, tree_map_with_path, tree_scale, tree_size,
                                    tree_sq_norm, tree_stack, tree_sub, tree_unflatten,
                                    tree_unstack, tree_weighted_sum, tree_zeros_like)

__all__ = ["fmt_bytes", "fmt_params", "tree_add", "tree_allclose", "tree_bytes", "tree_cast",
           "tree_dot", "tree_flatten_with_path", "tree_leaves", "tree_map",
           "tree_map_with_path", "tree_scale", "tree_size", "tree_sq_norm", "tree_stack",
           "tree_sub", "tree_unflatten", "tree_unstack", "tree_weighted_sum",
           "tree_zeros_like"]
