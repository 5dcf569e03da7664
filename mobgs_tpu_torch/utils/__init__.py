"""Timers, run logging, debug image grids and profiler traces."""
