"""What every cell shares: the spec, seeds, weights, timing, tracing, comparison and the result line."""
