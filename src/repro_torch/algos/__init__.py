"""Hand-staged algorithms and their numpy oracles."""
