from subgraph_sketching_tpu_torch.models.buddy import BUDDY  # noqa: F401
from subgraph_sketching_tpu_torch.models.convert import (  # noqa: F401
    adam_state_from_optax, buddy_state_dict_from_flax,
    elph_state_dict_from_flax, gcn_state_dict_from_flax,
    mlp_link_predictor_state_dict_from_flax, sage_conv_state_dict_from_flax,
    sage_state_dict_from_flax, seal_state_dict_from_flax,
)
from subgraph_sketching_tpu_torch.models.elph import (  # noqa: F401
    ELPH, ELPHPredictor,
)
from subgraph_sketching_tpu_torch.models.gnn import (  # noqa: F401
    GCN, SAGE, SIGN, GCNConv, MLPLinkPredictor, SAGEConv, SIGNEmbedding,
    batch_norm,
)
from subgraph_sketching_tpu_torch.models.predictor import (  # noqa: F401
    LinkPredictor,
)
