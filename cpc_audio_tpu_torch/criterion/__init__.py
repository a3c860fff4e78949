from .infonce import CPCUnsupervisedCriterion, build_criterion
from .prediction import PredictionNetwork
from .stacked_heads import StackedTransformerHeads

__all__ = ["CPCUnsupervisedCriterion", "PredictionNetwork",
           "StackedTransformerHeads", "build_criterion"]
