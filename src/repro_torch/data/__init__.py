from repro_torch.data.pipeline import (
    DataConfig,
    SyntheticTokenDataset,
    make_batch_iterator,
)

__all__ = ["DataConfig", "SyntheticTokenDataset", "make_batch_iterator"]
