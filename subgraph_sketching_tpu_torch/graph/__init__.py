from subgraph_sketching_tpu_torch.graph.container import Graph  # noqa: F401
from subgraph_sketching_tpu_torch.graph.synthetic import (  # noqa: F401
    barabasi_albert_graph,
    erdos_renyi_graph,
    watts_strogatz_graph,
    watts_strogatz_graph_fast,
)
