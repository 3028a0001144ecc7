from .matern import (
    HALF_INTEGER_NUS,
    matern,
    matern_covariance,
    pairwise_distance,
)
from .generator import (
    CORRELATION_LEVELS,
    Dataset,
    make_dataset,
    random_locations,
    simulate_field,
)
from .ordering import ORDERINGS, apply_ordering, hilbert_order, morton_order

__all__ = [
    "HALF_INTEGER_NUS", "matern", "matern_covariance", "pairwise_distance",
    "CORRELATION_LEVELS", "Dataset", "make_dataset", "random_locations",
    "simulate_field",
    "ORDERINGS", "apply_ordering", "hilbert_order", "morton_order",
]
