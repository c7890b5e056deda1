"""Layer-graph workloads: the LM graphs (``lm.py``); the CNN workloads of the
JAX package are not copied."""
from .lm import lm_graph  # noqa: F401
