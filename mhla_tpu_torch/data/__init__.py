"""Data pipelines (numpy) of the port: LM token streams, image folders, DiT
latents and webdataset-style tar shards."""

from .image_data import (
    ImageAugConfig,
    ImageFolderDataset,
    LatentDataset,
    center_crop_arr,
    list_image_folder,
    random_erasing,
)
from .native import TarShard
from .tar_shards import (
    ChunkedSampler,
    DistributedRangedSampler,
    ShardListDataset,
    default_decode,
    distributed_chunked_sampler,
    group_by_key,
    split_key,
    write_tar_shard,
)
from .lm_data import (
    PackedTokenIterator,
    PackedVarlenIterator,
    PackingState,
    batched,
    make_lm_dataloader,
    shard_documents,
    synthetic_documents,
)

__all__ = [
    "ChunkedSampler",
    "DistributedRangedSampler",
    "ImageAugConfig",
    "ImageFolderDataset",
    "LatentDataset",
    "PackedTokenIterator",
    "PackedVarlenIterator",
    "PackingState",
    "ShardListDataset",
    "TarShard",
    "batched",
    "center_crop_arr",
    "default_decode",
    "distributed_chunked_sampler",
    "group_by_key",
    "list_image_folder",
    "make_lm_dataloader",
    "random_erasing",
    "shard_documents",
    "split_key",
    "synthetic_documents",
    "write_tar_shard",
]
