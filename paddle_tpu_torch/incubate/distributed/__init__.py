"""Distributed incubating models of the port."""
