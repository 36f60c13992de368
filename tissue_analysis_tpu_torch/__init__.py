"""tissue_analysis_tpu_torch — 3D tissue morphometrics on PyTorch and CUDA.

The port of ``tissue_analysis_tpu`` (JAX/Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper. It imports neither ``jax`` nor
``tissue_analysis_tpu``; the JAX package is the reference its tables are
held against, field by field and exactly.

A segmented 2D or 3D image is relabeled on the host
(:class:`LabeledStack`), swept once per block on the device
(:func:`analyze_stack`, kernel ``csrc/block_sweep.cu``) into an exact
:class:`FeatureTable`, and exported as a cell property graph
(:func:`graph_from_table`). :func:`analyze_raw` skips the host relabel.
A block with more labels than the block sweep's dictionary takes goes
through the flat engine (``engine="chunked"``, :func:`analyze_stack_chunked`):
``engine="auto"`` counts every block's labels on the device before any
sweep and routes those blocks alone there, or the whole stack where that
does not pay.
The reference-compatible facade :func:`SpatialImageAnalysis` serves every
per-cell query from that one table. Time series go through
:func:`analyze_series` and :func:`temporal_graph_from_images` (lineage
analysis in ``graph.temporal``); stacks larger than device memory stream
through :func:`analyze_streamed` one z-slab at a time, and
:func:`analyze_sharded` splits a stack into z-slabs over the devices of a
:func:`make_mesh`.
"""

from tissue_analysis_tpu_torch.core.spatial_image import (  # noqa: F401
    SpatialImage,
    imread,
    imsave,
)
from tissue_analysis_tpu_torch.core.stack import LabeledStack  # noqa: F401
from tissue_analysis_tpu_torch.engine import (  # noqa: F401
    analyze,
    analyze_raw,
    analyze_stack,
    analyze_stack_blocked,
    analyze_stack_chunked,
    analyze_stack_pallas,
    collect_stack_pallas,
    dispatch_stack_pallas,
)
from tissue_analysis_tpu_torch.features.table import FeatureTable  # noqa: F401
from tissue_analysis_tpu_torch.analysis import (  # noqa: F401
    DICT,
    LIST,
    NPLIST,
    AbstractSpatialImageAnalysis,
    AnalysisConfig,
    SpatialImageAnalysis,
    SpatialImageAnalysis2D,
    SpatialImageAnalysis3D,
    SpatialImageAnalysis3DS,
)
from tissue_analysis_tpu_torch.graph import (  # noqa: F401
    PropertyGraph,
    TemporalPropertyGraph,
    dividing_cells,
    division_asymmetry,
    division_events,
    division_rate,
    exist_all_relative_at_rank,
    exist_relative_at_rank,
    graph_from_image,
    graph_from_table,
    lineage_vertices,
    lineage_volumes,
    nb_descendants,
    per_lineage_aggregate,
    relative_temporal_change,
    sibling_cells,
    temporal_change,
    temporal_rate,
    time_point_property,
)
from tissue_analysis_tpu_torch.streaming import (  # noqa: F401
    ArraySource,
    TiledSource,
    analyze_streamed,
)
from tissue_analysis_tpu_torch.series import (  # noqa: F401
    analyze_series,
    graph_series,
    temporal_graph_from_images,
)
from tissue_analysis_tpu_torch.parallel import (  # noqa: F401
    analyze_sharded,
    make_mesh,
)

__version__ = "0.1.0"
