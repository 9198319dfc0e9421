"""The benchmark's own code: discovery by name, the run, and the frozen
yardstick (peaks, operation and byte counts, the percentile, the token
generator, the weights made from the seed, the reading of the trace)."""
