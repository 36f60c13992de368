"""Device operators: the per-block sweep and the count of each block's
labels before it (``block_sweep``: CUDA kernels and plain versions), the
combine / pair reduction after it (``combine``), and the z-seam between two
streamed slabs (``seam``)."""
