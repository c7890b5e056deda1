"""The port's Algorithm 1 across the flavor seam (``search_mixed``) and the
paper's baselines on resnet152 x mcm64_hetero, against the JAX package: the
slowest case of ``test_torch_search.py``'s matrix, in a file of its own so
that it gets a worker of its own."""
from test_torch_search import check_algorithm1_and_baselines


def test_resnet152_on_the_hetero_package_matches_reference():
    check_algorithm1_and_baselines("resnet152", "mcm64_hetero")
