"""Data: the synthetic datasets, the epoch-keyed sampler and the device
feeder."""
