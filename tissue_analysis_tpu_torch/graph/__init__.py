from tissue_analysis_tpu_torch.graph.property_graph import (  # noqa: F401
    PropertyGraph,
    TemporalPropertyGraph,
)
from tissue_analysis_tpu_torch.graph.from_image import (  # noqa: F401
    graph_from_image,
    graph_from_table,
)
from tissue_analysis_tpu_torch.graph.temporal import (  # noqa: F401
    dividing_cells,
    division_asymmetry,
    division_events,
    division_rate,
    exist_all_relative_at_rank,
    exist_relative_at_rank,
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
