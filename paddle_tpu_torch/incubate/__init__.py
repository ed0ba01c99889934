"""Incubating APIs of the port (port of paddle_tpu/incubate)."""
