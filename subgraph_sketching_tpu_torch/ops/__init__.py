"""Graph ops of the port: the padded-tree plan (``segment_scan``), its
hand-written merge kernel K1 (``segscan``), the segment reductions
(``segment``) and the GCN normalisation and SpMM (``graph_ops``)."""
from subgraph_sketching_tpu_torch.ops.segment import (  # noqa: F401
    segment_max,
    segment_min,
    segment_sum,
)
from subgraph_sketching_tpu_torch.ops.graph_ops import (  # noqa: F401
    gcn_norm,
    spmm,
    degrees_from_edges,
)
