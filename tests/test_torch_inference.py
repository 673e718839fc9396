"""Port parity: exact full-graph inference.  ``full_graph_inference`` for
GraphSAGE (module and legacy call forms), GCN and GAT against the JAX
package's on the same graph, features and converted Flax parameters, with
``edge_chunk`` below the edge count so that the chunked stream runs.

Tolerance ``rtol=atol=1e-5`` (fp32, as for logits): the segment sums add
the same terms in another order (``index_add_`` against ``.at[].add``,
and other matmul blockings), so agreement is not bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quiver_tpu import telemetry
from quiver_tpu.models import GAT as FlaxGAT
from quiver_tpu.models import GCN as FlaxGCN
from quiver_tpu.models import GraphSAGE as FlaxSAGE
from quiver_tpu.models.inference import \
    full_graph_inference as jax_full_graph_inference
from quiver_tpu.sampler import GraphSageSampler as JaxSampler
from quiver_tpu.utils.rng import make_key
from quiver_tpu.utils.topology import CSRTopo as JaxTopo

import quiver_tpu_torch as qt

N, E, D, HIDDEN, CLASSES = 800, 6_000, 10, 8, 4
CHUNK = 1_000
TOL = dict(rtol=1e-5, atol=1e-5)

# the JAX package's telemetry switch as the process starts (collection
# runs before any test can change it)
_JAX_TELEMETRY_DEFAULT = telemetry.enabled()


@pytest.fixture(autouse=True)
def _clean_jax_registry():
    """The JAX calls here record metrics in the JAX package's registry;
    after each test it is emptied and the switch set back to its default,
    so nothing recorded here reaches a later file in the same worker."""
    yield
    telemetry.reset()
    telemetry.set_enabled(_JAX_TELEMETRY_DEFAULT)


@pytest.fixture(scope="module")
def data():
    indptr, indices = qt.synthetic_csr(N, E, seed=2)
    x = np.random.default_rng(3).standard_normal((N, D)).astype(np.float32)
    blocks = JaxSampler(JaxTopo(indptr=indptr, indices=indices), [3, 3],
                        gather_mode="xla", sample_rng="hash",
                        dedup="none").sample(np.arange(16),
                                             key=make_key(0)).layers
    return indptr, indices, x, blocks


FAMILIES = {
    "sage": (lambda: FlaxSAGE(hidden=HIDDEN, out_dim=CLASSES, num_layers=2),
             lambda: qt.GraphSAGE(D, HIDDEN, CLASSES, num_layers=2,
                                  device="cpu"),
             qt.sage_params_from_flax),
    "gcn": (lambda: FlaxGCN(hidden=HIDDEN, out_dim=CLASSES, num_layers=2),
            lambda: qt.GCN(D, HIDDEN, CLASSES, num_layers=2, device="cpu"),
            qt.gcn_params_from_flax),
    "gat": (lambda: FlaxGAT(hidden=HIDDEN, out_dim=CLASSES, num_layers=2,
                            heads=2),
            lambda: qt.GAT(D, HIDDEN, CLASSES, num_layers=2, heads=2,
                           device="cpu"),
            qt.gat_params_from_flax),
}


def pair(family, data):
    indptr, indices, x, blocks = data
    make_flax, make_port, from_flax = FAMILIES[family]
    fm = make_flax()
    x_frontier = jnp.asarray(np.zeros((4000, D), np.float32))
    params = fm.init(jax.random.PRNGKey(4), x_frontier, blocks)
    pm = make_port()
    pm.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params)))
    want = np.asarray(jax_full_graph_inference(fm, params, x, indptr,
                                               indices, edge_chunk=CHUNK))
    return fm, params, pm, want


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_full_graph_inference_matches_jax(data, family):
    indptr, indices, x, _ = data
    _, _, pm, want = pair(family, data)
    assert want.shape == (N, CLASSES)
    got = qt.full_graph_inference(pm, None, x, indptr, indices,
                                  edge_chunk=CHUNK, device="cpu")
    assert got.shape == (N, CLASSES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the module's own parameters or an explicit state_dict; any chunking
    whole = qt.full_graph_inference(pm, pm.state_dict(), torch.from_numpy(x),
                                    indptr, indices, edge_chunk=10 * E,
                                    device="cpu")
    np.testing.assert_allclose(whole.numpy(), want, **TOL)


def test_sage_legacy_forms_match_jax(data):
    indptr, indices, x, _ = data
    _, params, pm, want = pair("sage", data)
    jax_legacy = np.asarray(jax_full_graph_inference(
        params, x, indptr, indices, 2, edge_chunk=CHUNK))
    np.testing.assert_array_equal(jax_legacy, want)
    for first in (pm.state_dict(), pm):
        got = qt.full_graph_inference(first, x, indptr, indices, 2,
                                      edge_chunk=CHUNK, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = qt.full_graph_inference(pm.state_dict(), x, indptr, indices,
                                  num_layers=2, edge_chunk=CHUNK,
                                  device="cpu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_refusals(data):
    indptr, indices, x, _ = data
    gcn = qt.GCN(D, HIDDEN, CLASSES, device="cpu")
    with pytest.raises(ValueError, match="num_layers"):
        qt.full_graph_inference(gcn.state_dict(), x, indptr, indices,
                                device="cpu")
    with pytest.raises(TypeError, match="legacy"):
        qt.full_graph_inference(gcn, x, indptr, indices, 2, device="cpu")
    with pytest.raises(TypeError, match="unsupported"):
        qt.full_graph_inference(torch.nn.Linear(2, 2), None, x, indptr,
                                indices, device="cpu")
