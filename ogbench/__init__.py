"""The port's benchmark: see ogbench/run.py."""
