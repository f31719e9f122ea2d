"""Functional optimizers of the port."""
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          global_norm, sgd, tree_leaves,
                                          tree_map)

__all__ = ["Optimizer", "clip_by_global_norm", "global_norm", "sgd",
           "tree_leaves", "tree_map"]
