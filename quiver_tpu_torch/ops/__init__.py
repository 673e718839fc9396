from .sample import (sample_neighbors, sample_neighbors_weighted,
                     row_cumsum_weights, SampleOut, to_ragged)
from .reindex import reindex, ReindexOut
from .prob import cal_neighbor_prob, sample_prob

__all__ = ["SampleOut", "sample_neighbors", "sample_neighbors_weighted",
           "row_cumsum_weights", "to_ragged", "reindex", "ReindexOut",
           "cal_neighbor_prob", "sample_prob"]
