"""Hand-written CUDA kernels of the port and their wrappers.

``KERNELS`` names each kernel's library, built from ``csrc/<name>.cu`` and
the ``csrc`` headers it includes (B3 and B4 share ``element_gather.cuh``).
"""

KERNELS = ("window_sample", "gather_rows", "element_gather", "lane_select",
           "page_gather")

__all__ = ["KERNELS"]
