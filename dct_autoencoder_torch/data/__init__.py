from .shards import ShardWriter, WebDatasetReader, expand_urls, iter_tar_samples, decode_sample
from .dataset import (
    default_size_buckets,
    resize_to_bucket,
    batched,
    dict_collate,
    load_and_transform_dataset,
    load_preprocessed_dataset,
    tuple_collate,
)

__all__ = [
    "default_size_buckets",
    "resize_to_bucket",
    "ShardWriter",
    "WebDatasetReader",
    "expand_urls",
    "iter_tar_samples",
    "decode_sample",
    "batched",
    "dict_collate",
    "load_and_transform_dataset",
    "load_preprocessed_dataset",
    "tuple_collate",
]
