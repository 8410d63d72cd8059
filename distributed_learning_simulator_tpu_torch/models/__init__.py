"""Model zoo of the port; importing it registers the ported models."""

from . import bert  # noqa: F401  (registers bert_base, bert_small, bert_tiny)
from . import graph  # noqa: F401  (registers TwoGCN, ThreeGCN, SimpleGCN, OneGCN)
from . import long_context  # noqa: F401  (registers LongContextTransformer, CausalLMTransformer)
from . import text  # noqa: F401  (registers TransformerClassificationModel)
from . import vision  # noqa: F401  (registers LeNet5, densenet40, resnet18, resnet50)
from . import vit  # noqa: F401  (registers vit_small, vit_base, vit_tiny)
from .registry import ModelContext, create_model_context, global_model_factory

__all__ = ["ModelContext", "create_model_context", "global_model_factory"]
