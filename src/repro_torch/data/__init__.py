"""Device-resident datasets of the port."""
from repro_torch.data.pipeline import (ArrayDataset, gather_batch,
                                       make_svhn_like, make_token_dataset)

__all__ = ["ArrayDataset", "gather_batch", "make_svhn_like",
           "make_token_dataset"]
