from repro_torch.models.config import ArchConfig, MoEConfig, ShapeConfig, SHAPES
from repro_torch.models.paper_nets import (
    cnn_apply,
    cnn_init,
    make_classifier_loss,
    mlp_apply,
    mlp_init,
    softmax_xent,
)
from repro_torch.models.transformer import TransformerLM, make_lm_loss

__all__ = ["ArchConfig", "MoEConfig", "SHAPES", "ShapeConfig", "TransformerLM",
           "cnn_apply", "cnn_init", "make_classifier_loss", "make_lm_loss", "mlp_apply",
           "mlp_init", "softmax_xent"]
