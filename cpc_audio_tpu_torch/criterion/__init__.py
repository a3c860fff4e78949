from .infonce import CPCUnsupervisedCriterion, build_criterion
from .prediction import PredictionNetwork
from .stacked_heads import StackedTransformerHeads
from .supervised import CTCPhoneCriterion, PhoneCriterion, SpeakerCriterion

__all__ = ["CPCUnsupervisedCriterion", "CTCPhoneCriterion", "PhoneCriterion",
           "PredictionNetwork", "SpeakerCriterion", "StackedTransformerHeads",
           "build_criterion"]
