from .prefetch import AsyncCudaNeighborSampler, AsyncNeighborSampler, Prefetcher
from .train import (TrainState, make_train_step, masked_cross_entropy,
                    replicate, shard_batch)

__all__ = ["AsyncCudaNeighborSampler", "AsyncNeighborSampler", "Prefetcher",
           "TrainState", "make_train_step", "masked_cross_entropy", "replicate",
           "shard_batch"]
