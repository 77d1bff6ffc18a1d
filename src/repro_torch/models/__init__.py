from repro_torch.models.paper_nets import (
    cnn_apply,
    cnn_init,
    make_classifier_loss,
    mlp_apply,
    mlp_init,
    softmax_xent,
)

__all__ = ["cnn_apply", "cnn_init", "make_classifier_loss", "mlp_apply",
           "mlp_init", "softmax_xent"]
