"""Functional optimizers of the port."""
from repro_torch.optim.optimizers import (Optimizer, adam, apply_updates,
                                          clip_by_global_norm,
                                          cosine_schedule, global_norm, sgd,
                                          tree_leaves, tree_map,
                                          warmup_cosine)

__all__ = ["Optimizer", "adam", "apply_updates", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "sgd", "tree_leaves",
           "tree_map", "warmup_cosine"]
