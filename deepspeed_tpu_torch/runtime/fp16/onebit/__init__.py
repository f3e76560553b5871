"""The 1-bit optimizers: 1-bit Adam, 1-bit LAMB and 0/1 Adam."""

from .adam import OnebitAdam  # noqa: F401
from .lamb import OnebitLamb  # noqa: F401
from .zoadam import ZeroOneAdam  # noqa: F401
