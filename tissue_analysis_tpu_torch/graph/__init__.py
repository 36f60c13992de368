from tissue_analysis_tpu_torch.graph.property_graph import (  # noqa: F401
    PropertyGraph,
    TemporalPropertyGraph,
)
from tissue_analysis_tpu_torch.graph.from_image import (  # noqa: F401
    graph_from_image,
    graph_from_table,
)
