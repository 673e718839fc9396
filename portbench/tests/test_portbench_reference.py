"""The plain reference against examples checked by hand."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import sage, sampler

M32 = 0xFFFFFFFF


def _fmix(x: int) -> int:
    x ^= x >> 16
    x = (x * sampler.MUL1) & M32
    x ^= x >> 13
    x = (x * sampler.MUL2) & M32
    return x ^ (x >> 16)


def _uniform(k0: int, k1: int, c: int) -> float:
    x = (c * sampler.PHI) & M32
    x = _fmix(x ^ k0)
    x = _fmix(x ^ k1)
    return (x >> 8) / float(1 << 24)


@pytest.mark.parametrize("k0, k1", [(0, 0), (123456789, 987654321),
                                    (M32, 1)])
def test_hash_uniform_matches_scalar_arithmetic(k0, k1):
    got = sampler.hash_uniform(k0, k1, 40, "cpu")
    want = [_uniform(k0, k1, c) for c in range(40)]
    assert got.dtype == torch.float32
    assert got.tolist() == want


def test_hop_by_hand():
    # node 0: neighbours 5, 6 (degree 2); node 1: 10..15 (degree 6)
    indptr = torch.tensor([0, 2, 8], dtype=torch.int64)
    indices = torch.tensor([5, 6, 10, 11, 12, 13, 14, 15], dtype=torch.int32)
    seeds = torch.tensor([0, 1, 1], dtype=torch.int32)
    live = torch.tensor([True, True, False])
    mask, nbrs, eid = sampler.hop(indptr, indices, seeds, live, 3, 7, 9)
    # degree <= k: the first deg slots, in order; a dead target: nothing
    assert mask.tolist() == [[True, True, False], [True, True, True],
                             [False, False, False]]
    assert nbrs[0].tolist() == [5, 6, 0] and eid[0].tolist() == [0, 1, -1]
    # degree 6 at k = 3: slot j draws from positions [2j, 2j + 2)
    u = [_uniform(7, 9, 3 + j) for j in range(3)]
    assert eid[1].tolist() == [2 + 2 * j + int(u[j] * 2) for j in range(3)]
    assert nbrs[1].tolist() == [int(indices[e]) for e in eid[1]]


def test_positional_pipeline_by_hand():
    indptr = torch.tensor([0, 1, 2, 3], dtype=torch.int64)
    indices = torch.tensor([1, 2, 0], dtype=torch.int32)  # a 3-cycle
    out = sampler.sample(indptr, indices, torch.tensor([0]), [2, 1],
                         np.array([[1, 2], [3, 4]], dtype=np.uint32))
    # hop 1: node 0's one neighbour 1, then an empty slot; hop 2 over
    # [0, 1, 0(empty)]: 1, 2, nothing
    assert out.n_id.tolist() == [0, 1, 0, 1, 2, 0]
    assert out.n_mask.tolist() == [True, True, False, True, True, False]
    assert out.hops[0].nbr_local.tolist() == [[1, 0]]
    assert out.hops[1].nbr_local.tolist() == [[3], [4], [0]]


def test_forward_by_hand():
    x = torch.tensor([[1.0], [2.0], [4.0]])
    blocks = [(torch.tensor([[1, 2]], dtype=torch.int32),
               torch.tensor([[True, False]]))]
    params = {"convs.0.lin_self.weight": torch.tensor([[3.0]]),
              "convs.0.lin_self.bias": torch.tensor([1.0]),
              "convs.0.lin_nbr.weight": torch.tensor([[10.0]])}
    # 1 * 3 + 1 + mean(2) * 10
    assert sage.forward(params, x, blocks, 1).tolist() == [[24.0]]


def test_loss_and_adam_by_hand():
    logits = torch.tensor([[0.0, 0.0], [5.0, 1.0]])
    labels = torch.tensor([0, 1])
    mask = torch.tensor([True, False])
    assert float(sage.masked_ce(logits, labels, mask)) == \
        pytest.approx(math.log(2.0))
    p = {"w": torch.tensor([1.0])}
    opt = sage.Adam(p, lr=0.1)
    opt.step(p, {"w": torch.tensor([2.0])})
    # m_hat = 2, v_hat = 4: 1 - 0.1 * 2 / (2 + 1e-8)
    assert float(p["w"]) == pytest.approx(0.9, abs=1e-7)


def test_tf32_rounding():
    one = torch.tensor([1.0 + 2**-12, 1.0 + 2**-10, -(1.0 + 3 * 2**-11)])
    assert sage.tf32_round(one).tolist() == [1.0, 1.0 + 2**-10,
                                             -(1.0 + 2 * 2**-10)]
