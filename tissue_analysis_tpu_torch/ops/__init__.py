"""Device operators: the per-block sweep (``block_sweep``: CUDA kernel and
plain version), the combine / pair reduction after it (``combine``), and
the z-seam between two streamed slabs (``seam``)."""
