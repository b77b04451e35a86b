"""Datasets of the port: the MDS shard format and the train-time loader
(counterparts of micro_diffusion_tpu/datasets/mds.py and latents_loader.py), the
caption cleaner (``captions``) and the latent precompute (``prepare``)."""

from .latents_loader import (LatentsDataLoader, StreamingLatentsDataset,
                             build_streaming_latents_dataloader)
from .mds import MDSReader, MDSWriter, merge_index

__all__ = ["LatentsDataLoader", "StreamingLatentsDataset",
           "build_streaming_latents_dataloader", "MDSReader", "MDSWriter", "merge_index"]
