"""Placement hashing for the PS fleet, the port's own copy of
``elasticdl_tpu/common/hash_utils.py``: a dense parameter lives on shard
``sha256(name) % n``, an embedding row on shard ``id % n``. Both packages
place a name and an id on the same shard.
"""

import hashlib

import numpy as np


def string_to_id(name, bucket_num):
    """The shard of parameter ``name`` among ``bucket_num`` (sha256 %
    buckets)."""
    if bucket_num <= 0:
        raise ValueError("bucket_num must be positive")
    digest = hashlib.sha256(name.encode("utf-8")).hexdigest()
    return int(digest, 16) % bucket_num


def int_to_id(number, bucket_num):
    """The shard of embedding row ``number`` (id % buckets)."""
    if bucket_num <= 0:
        raise ValueError("bucket_num must be positive")
    return int(number) % bucket_num


def scatter_embedding_vector(values, ids, bucket_num):
    """Group rows by shard: ``{shard: (values_subset, ids_subset)}``;
    ``values`` is (n, dim), ``ids`` (n,)."""
    if bucket_num <= 0:
        raise ValueError("bucket_num must be positive")
    values = np.asarray(values)
    ids = np.asarray(ids, dtype=np.int64)
    if values.shape[0] != ids.shape[0]:
        raise ValueError("values and ids must have the same leading dim")
    shard_ids = ids % bucket_num
    result = {}
    for shard in np.unique(shard_ids):
        mask = shard_ids == shard
        result[int(shard)] = (values[mask], ids[mask])
    return result
