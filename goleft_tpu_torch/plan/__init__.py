"""Execution plan of the port: the Step data model (core.py) and its
executor (executor.py), trimmed copies of the JAX package's plan
layer."""

from .core import Step, StepOutcome
from .executor import Executor, InflightSteps, run_device_step

__all__ = ["Executor", "InflightSteps", "Step", "StepOutcome",
           "run_device_step"]
