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
The reference-compatible facade :func:`SpatialImageAnalysis` serves every
per-cell query from that one table.
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
    graph_from_image,
    graph_from_table,
)

__version__ = "0.1.0"
