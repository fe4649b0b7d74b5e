"""SEM preprocessing: build the per-pair cache (the port's own copy
of umeregrobust_tpu/data/sem_preprocess.py; host-side numpy).

Iterates a dataset in preprocess mode with SEM equalization and pickles
each pair to {output}/{split}/{seq}/{frame0:06d}_{frame1:06d}.pickle in
the reference's dict schema (datasets/sem_preprocessing.py:8-85). Files
that exist are skipped, so a run resumes; an index range shards the
split by hand across hosts.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

from umeregrobust_tpu_torch.data.datasets import (
    PAIR_KEYS, NuscenesDataset, SemanticKITTIDataset, save_pair_pickle)

__all__ = ["run_sem_preprocessing"]


def run_sem_preprocessing(
    dataset_mode: str,
    split: str,
    data_path: str,
    output_path: str,
    range_idxs: Optional[Tuple[int, int]] = None,
    use_pc_completion: bool = True,
    verbose: bool = True,
) -> int:
    """Returns the number of pairs written (existing files are skipped)."""
    cls = SemanticKITTIDataset if dataset_mode == "kitti" else NuscenesDataset
    dset = cls(
        data_path=data_path,
        split=split,
        cache_data_path="",
        use_pc_completion=use_pc_completion,
        convert_points_to_grid=True,
        skip_invalid_entries=False,
    )
    lo, hi = range_idxs if range_idxs is not None else (0, len(dset))
    hi = min(hi, len(dset))
    written = 0
    for itr in range(lo, hi):
        out_file = dset.cache_file(itr, output_path)
        if os.path.exists(out_file):
            continue
        save_pair_pickle(out_file,
                         dict(zip(PAIR_KEYS, dset.preprocess_getitem(itr))))
        written += 1
        if verbose and written % 50 == 0:
            print(f"[sem] {split} {itr - lo + 1}/{hi - lo} written={written}",
                  flush=True)
    return written
