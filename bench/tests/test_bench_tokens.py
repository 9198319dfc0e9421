"""The frozen token generator gives the port's batches bit for bit."""
import numpy as np

import bench_support  # noqa: F401 (bench/ and src/ on the path)
from benchkit import tokens


def test_same_batches_as_the_ports_generator():
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenDataset

    for seed, step, vocab, seq in ((0, 0, 1000, 64), (2**33 + 5, 3, 1000, 64),
                                   (2**31 + 9, 7, 100352, 600)):
        ds = SyntheticTokenDataset(DataConfig(vocab=vocab, seq_len=seq, global_batch=3,
                                              seed=seed))
        want = ds.batch(step)
        got = tokens.batch(vocab, seq, 3, seed, step)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
