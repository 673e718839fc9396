from .prefetch import AsyncCudaNeighborSampler, AsyncNeighborSampler, Prefetcher
from .train import TrainState, make_train_step, masked_cross_entropy

__all__ = ["AsyncCudaNeighborSampler", "AsyncNeighborSampler", "Prefetcher",
           "TrainState", "make_train_step", "masked_cross_entropy"]
