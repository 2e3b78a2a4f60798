from .cholesky import chol_rank1_update, chol_rank1_update_batched
from .pallas_mh import fused_rwmh_sample, tile_fn_from_batched, tile_rows

__all__ = [
    "chol_rank1_update",
    "chol_rank1_update_batched",
    "fused_rwmh_sample",
    "tile_fn_from_batched",
    "tile_rows",
]
