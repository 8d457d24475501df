"""Example AIRs: the basic three-column AIR and wide Fibonacci."""
