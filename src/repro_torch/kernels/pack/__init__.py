from .ops import (PackSpec, PackedBatch, device_stage, flatten_tree,
                  host_stage, pack, stack_trees, unflatten_tree, unpack,
                  unpack_flat)

__all__ = ["PackSpec", "PackedBatch", "device_stage", "flatten_tree",
           "host_stage", "pack", "stack_trees", "unflatten_tree", "unpack",
           "unpack_flat"]
