"""Models of the port's incubate.distributed."""
