"""The multi-process layer of the port on ``torch.distributed``: the
runtime (``multihost``), the collectives of a data-parallel step and
their count (``collectives``), the data-parallel mesh (``mesh``), the
heartbeat failure detector (``fault``).  The distributed ELPH step and
its oracle (``parallel.train``) and the multi-rank dry run
(``parallel.dryrun``) import the models and are imported from their
modules.  The graph and lane axes (memory-sharded sketch state) are not
ported yet."""

from subgraph_sketching_tpu_torch.parallel.collectives import (  # noqa: F401
    gather_replicated,
    sum_across_ranks,
    sum_replicated,
)
from subgraph_sketching_tpu_torch.parallel.fault import (  # noqa: F401
    HeartbeatDetector,
    PeerFailure,
    maybe_start,
)
from subgraph_sketching_tpu_torch.parallel.mesh import (  # noqa: F401
    FlatGrads,
    Mesh,
    batch_sharding,
    flat_grads,
    make_mesh,
    replicated,
)
from subgraph_sketching_tpu_torch.parallel.multihost import (  # noqa: F401
    host_local_batch,
    initialize,
    process_shard,
)
