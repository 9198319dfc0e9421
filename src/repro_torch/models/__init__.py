"""LM models of the serving path: dense GQA transformers, RWKV-6 and
the Jamba hybrid (mamba and attention mixers, dense and MoE ffns), with
their attention, WKV and selective-scan recurrences on the hand-written
kernels."""
