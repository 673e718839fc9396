"""``ForkingPickler`` reducers for :class:`Feature` and
:class:`GraphSageSampler` (counterpart of
``quiver_tpu/multiprocessing/reductions.py``)."""

from __future__ import annotations

from multiprocessing.reduction import ForkingPickler

from ..feature import Feature
from ..sampler import GraphSageSampler

__all__ = ["init_reductions"]


def rebuild_feature(handle):
    return Feature.lazy_from_ipc_handle(handle)


def reduce_feature(f: Feature):
    return (rebuild_feature, (f.share_ipc(),))


def rebuild_sampler(handle):
    return GraphSageSampler.lazy_from_ipc_handle(handle)


def reduce_sampler(s: GraphSageSampler):
    return (rebuild_sampler, (s.share_ipc(),))


def init_reductions():
    ForkingPickler.register(Feature, reduce_feature)
    ForkingPickler.register(GraphSageSampler, reduce_sampler)


init_reductions()
