"""Device operators: the per-block sweep (``block_sweep``: CUDA kernel and
plain version) and the combine / pair reduction after it (``combine``)."""
