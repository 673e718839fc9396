"""Hand-written CUDA kernels of the port and their wrappers.

``KERNELS`` names each kernel's library, built from ``csrc/<name>.cu`` and
the ``csrc`` headers it includes (B3 and B4 share ``element_gather.cuh``;
B1 and ``threefry_uniform`` share the cipher of ``threefry.cuh``).  The
first five replace the JAX package's Pallas kernels B1-B5;
``threefry_uniform`` is the counterpart of XLA's ``jax.random.uniform``
under ``sample_rng="key"`` at the draw sites B1 does not fuse;
``sage_mean`` is SAGEConv's neighbour mean and its gradient,
``sage_act`` GraphSAGE's hidden-layer ReLU and dropout in training and
their gradient, and ``sage_act_mean`` the two fused over a positional
block, all of which the JAX package leaves to XLA (the three share the
element helpers of ``sage.cuh``).
"""

KERNELS = ("window_sample", "gather_rows", "element_gather", "lane_select",
           "page_gather", "threefry_uniform", "sage_mean", "sage_act",
           "sage_act_mean")

__all__ = ["KERNELS"]
