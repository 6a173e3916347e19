from repro_torch.utils.tree import (tree_add, tree_bytes, tree_flatten_with_path, tree_leaves,
                                    tree_map, tree_map_with_path, tree_size, tree_sq_norm,
                                    tree_stack, tree_sub, tree_unflatten, tree_unstack,
                                    tree_weighted_sum, tree_zeros_like)

__all__ = ["tree_add", "tree_bytes", "tree_flatten_with_path", "tree_leaves", "tree_map",
           "tree_map_with_path", "tree_size", "tree_sq_norm", "tree_stack", "tree_sub",
           "tree_unflatten", "tree_unstack", "tree_weighted_sum", "tree_zeros_like"]
