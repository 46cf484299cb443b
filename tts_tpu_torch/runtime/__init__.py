"""Serving runtimes of the port: the continuous-batching Parler engine."""
