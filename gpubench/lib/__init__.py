"""What every cell shares: finding files by name, data and weights from the
seed, the bounds, the peaks, the trace reduction and the comparison."""
