"""Step functions (train, prefill, one-token decode) and the training driver."""
