"""Train and validation steps of the port, and its data parallelism (one
process a device, ``distributed``)."""
from . import distributed

__all__ = ["distributed"]
