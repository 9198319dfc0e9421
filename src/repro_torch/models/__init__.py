"""LM models of the serving path: dense GQA transformers and RWKV-6,
with their attention and WKV recurrences on the hand-written kernels."""
