from .runner import ResilientTrainer, StragglerMonitor  # noqa: F401
