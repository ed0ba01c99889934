"""Serving path of the port: paged decoder and continuous batching."""
