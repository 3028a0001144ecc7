from .matern import (
    HALF_INTEGER_NUS,
    kv,
    matern,
    matern_covariance,
    pairwise_distance,
)
from .generator import (
    CORRELATION_LEVELS,
    WIND_REGIONS,
    Dataset,
    make_dataset,
    random_locations,
    simulate_field,
    wind_like_dataset,
)
from .ordering import ORDERINGS, apply_ordering, hilbert_order, morton_order

__all__ = [
    "HALF_INTEGER_NUS", "kv", "matern", "matern_covariance", "pairwise_distance",
    "CORRELATION_LEVELS", "WIND_REGIONS", "Dataset", "make_dataset",
    "random_locations", "simulate_field", "wind_like_dataset",
    "ORDERINGS", "apply_ordering", "hilbert_order", "morton_order",
]
