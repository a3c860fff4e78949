from .infonce import CPCUnsupervisedCriterion, NoneCriterion, build_criterion
from .prediction import PredictionNetwork
from .stacked_heads import StackedTransformerHeads
from .supervised import CTCPhoneCriterion, PhoneCriterion, SpeakerCriterion

__all__ = ["CPCUnsupervisedCriterion", "CTCPhoneCriterion", "NoneCriterion",
           "PhoneCriterion", "PredictionNetwork", "SpeakerCriterion",
           "StackedTransformerHeads", "build_criterion"]
