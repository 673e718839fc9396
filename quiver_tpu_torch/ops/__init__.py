from .sample import SampleOut, sample_neighbors, to_ragged

__all__ = ["SampleOut", "sample_neighbors", "to_ragged"]
