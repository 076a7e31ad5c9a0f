from subgraph_sketching_tpu_torch.models.buddy import BUDDY  # noqa: F401
from subgraph_sketching_tpu_torch.models.convert import (  # noqa: F401
    adam_state_from_optax, buddy_state_dict_from_flax,
)
from subgraph_sketching_tpu_torch.models.gnn import SIGN, batch_norm  # noqa: F401
