"""Data pipelines (numpy) of the port: LM token streams, image folders and
DiT latents."""

from .image_data import (
    ImageAugConfig,
    ImageFolderDataset,
    LatentDataset,
    center_crop_arr,
    list_image_folder,
    random_erasing,
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
    "ImageAugConfig",
    "ImageFolderDataset",
    "LatentDataset",
    "PackedTokenIterator",
    "PackedVarlenIterator",
    "PackingState",
    "batched",
    "center_crop_arr",
    "list_image_folder",
    "make_lm_dataloader",
    "random_erasing",
    "shard_documents",
    "synthetic_documents",
]
