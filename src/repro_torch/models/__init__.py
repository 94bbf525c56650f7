"""Language-model assembly over the paged state cache, and the paper's
own MLP (§4.1)."""
from .mlp_mnist import (PAPER_LAYERS, mlp_net_apply, mlp_net_init,
                        paper_mlp_apply, paper_mlp_init, paper_mlp_loss,
                        paper_mlp_predict)

__all__ = ["PAPER_LAYERS", "mlp_net_apply", "mlp_net_init",
           "paper_mlp_apply", "paper_mlp_init", "paper_mlp_loss",
           "paper_mlp_predict"]
