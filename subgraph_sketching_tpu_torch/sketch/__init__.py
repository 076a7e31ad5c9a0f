from subgraph_sketching_tpu_torch.sketch.params import SketchParams, Sketches  # noqa: F401
from subgraph_sketching_tpu_torch.sketch.elph import (  # noqa: F401
    build_hash_tables,
    subgraph_features,
    propagate_minhash,
    propagate_hll,
)
from subgraph_sketching_tpu_torch.sketch.hll import hll_count, hll_merge  # noqa: F401
from subgraph_sketching_tpu_torch.sketch.minhash import minhash_init, jaccard  # noqa: F401
from subgraph_sketching_tpu_torch.sketch.node_hash import splitmix64  # noqa: F401
