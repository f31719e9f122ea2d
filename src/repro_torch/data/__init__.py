"""Datasets of the port: device-resident arrays (``pipeline``), the
host chunk store (``store``) and the streaming data plane
(``streaming``)."""
from repro_torch.data.pipeline import (GATHER_MODES, ArrayDataset,
                                       gather_batch, make_svhn_like,
                                       make_token_dataset, take_rows)
from repro_torch.data.store import ChunkedExampleStore

__all__ = ["ArrayDataset", "GATHER_MODES", "ChunkedExampleStore",
           "gather_batch", "make_svhn_like", "make_token_dataset",
           "take_rows"]
