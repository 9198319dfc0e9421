"""LM serving step functions (prefill and one-token decode)."""
