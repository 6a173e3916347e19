from repro_torch.utils.tree import (tree_bytes, tree_leaves, tree_map, tree_unflatten,
                                    tree_zeros_like)

__all__ = ["tree_bytes", "tree_leaves", "tree_map", "tree_unflatten", "tree_zeros_like"]
