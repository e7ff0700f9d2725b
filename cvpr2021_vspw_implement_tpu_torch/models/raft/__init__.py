from .raft import (RAFT, bucketed_flow, coords_grid, pad_to_multiple_of_8,
                   unpad, upsample_flow_convex)

__all__ = ["RAFT", "bucketed_flow", "coords_grid", "pad_to_multiple_of_8",
           "unpad", "upsample_flow_convex"]
