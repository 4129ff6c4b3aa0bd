"""Launchers of the port: the serving and training entry points and
their profilers."""
