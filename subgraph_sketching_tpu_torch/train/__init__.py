from subgraph_sketching_tpu_torch.train.losses import (  # noqa: F401
    auc_loss, bce_loss, get_loss,
)
from subgraph_sketching_tpu_torch.train.evaluation import (  # noqa: F401
    evaluate_auc, evaluate_hits, evaluate_mrr,
)
