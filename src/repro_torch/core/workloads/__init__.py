"""Layer-graph workloads: the paper's CNNs (``cnn.py``) and the LM graphs
(``lm.py``), as in the JAX package's ``core/workloads/``."""
from .cnn import CNN_WORKLOADS, get_cnn  # noqa: F401
from .lm import lm_graph  # noqa: F401
