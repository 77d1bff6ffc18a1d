from repro_torch.models.config import (
    ArchConfig,
    MoEConfig,
    ShapeConfig,
    SHAPES,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
)
from repro_torch.models.paper_nets import (
    cnn_apply,
    cnn_init,
    make_classifier_loss,
    mlp_apply,
    mlp_init,
    softmax_xent,
)
from repro_torch.models.transformer import TransformerLM, make_lm_loss

__all__ = ["ArchConfig", "MoEConfig", "SHAPES", "ShapeConfig", "TRAIN_4K", "PREFILL_32K",
           "DECODE_32K", "LONG_500K", "TransformerLM",
           "cnn_apply", "cnn_init", "make_classifier_loss", "make_lm_loss", "mlp_apply",
           "mlp_init", "softmax_xent"]
