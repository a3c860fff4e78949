from .group_computation import (dtw_batch, get_abx_scores_dtw_on_group,
                                get_cosine_distance_batch,
                                get_distance_function_from_name,
                                get_distance_group_dtw,
                                get_euclidian_distance_batch,
                                get_theta_group_dtw)
from .iterators import (ABXAcrossGroupIterator, ABXFeatureLoader,
                        ABXWithinGroupIterator, get_features_group,
                        load_item_file, normalize_with_singularity)

__all__ = [
    "dtw_batch", "get_abx_scores_dtw_on_group", "get_cosine_distance_batch",
    "get_distance_function_from_name", "get_distance_group_dtw",
    "get_euclidian_distance_batch", "get_theta_group_dtw",
    "ABXAcrossGroupIterator", "ABXFeatureLoader", "ABXWithinGroupIterator",
    "get_features_group", "load_item_file", "normalize_with_singularity",
]
