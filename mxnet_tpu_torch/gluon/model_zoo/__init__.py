"""Model zoo of the PyTorch port."""
from . import transformer, vision  # noqa: F401
