"""Model zoo of the PyTorch port."""
from . import transformer  # noqa: F401
