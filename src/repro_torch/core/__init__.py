"""Numerics and optimizer core of the port (precision, schedule, label
smoothing, parameter init, bucketing, LARS)."""
