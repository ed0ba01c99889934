"""Quantization of the port (serving-side int8 calibration so far)."""
