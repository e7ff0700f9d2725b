from .raft import RAFT, coords_grid, pad_to_multiple_of_8, unpad, upsample_flow_convex

__all__ = ["RAFT", "coords_grid", "pad_to_multiple_of_8", "unpad",
           "upsample_flow_convex"]
