from .ops import (PackSpec, PackedBatch, device_stage, flatten_tree, pack,
                  unflatten_tree, unpack, unpack_flat)

__all__ = ["PackSpec", "PackedBatch", "device_stage", "flatten_tree",
           "pack", "unflatten_tree", "unpack", "unpack_flat"]
