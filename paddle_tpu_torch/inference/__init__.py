"""Serving path of the port: paged decoder and continuous batching."""
from .paged import PagedGenerator  # noqa: F401
