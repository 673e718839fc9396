"""Hand-written CUDA kernels of the port and their wrappers.

``KERNELS`` names each kernel's library, built from ``csrc/<name>.cu`` and
the ``csrc`` headers it includes (B3 and B4 share ``element_gather.cuh``;
B1 and ``threefry_uniform`` share the cipher of ``threefry.cuh``).  The
first five replace the JAX package's Pallas kernels B1-B5;
``threefry_uniform`` is the counterpart of XLA's ``jax.random.uniform``
under ``sample_rng="key"`` at the draw sites B1 does not fuse.
"""

KERNELS = ("window_sample", "gather_rows", "element_gather", "lane_select",
           "page_gather", "threefry_uniform")

__all__ = ["KERNELS"]
