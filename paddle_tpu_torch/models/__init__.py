"""Models of the port."""
from .crnn import CRNN, crnn_tiny

__all__ = ["CRNN", "crnn_tiny"]
