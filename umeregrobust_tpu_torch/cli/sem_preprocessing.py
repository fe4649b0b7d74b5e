"""SEM preprocessing CLI of the port (host-side numpy; the counterpart of
umeregrobust_tpu/cli/sem_preprocessing.py, reference
datasets/sem_preprocessing.py:13-24):

    python -m umeregrobust_tpu_torch.cli.sem_preprocessing \
        --dataset_mode kitti --split test \
        --data_path /data/kitti/sequences --output_path /data/kitti_sem_cache \
        --range_idxs 0 1000

writes {output_path}/{split}/{seq}/{f0:06d}_{f1:06d}.pickle for the pairs
[lo, hi) of the split, skipping files that exist.
"""
from __future__ import annotations

import argparse

from umeregrobust_tpu_torch.data.sem_preprocess import run_sem_preprocessing


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_mode", choices=["kitti", "nuscenes"],
                        required=True)
    parser.add_argument("--split", required=True)
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--range_idxs", type=int, nargs=2, default=None,
                        help="process pairs [lo, hi) (manual sharding)")
    parser.add_argument("--no_pc_completion", action="store_true")
    args = parser.parse_args(argv)
    n = run_sem_preprocessing(
        dataset_mode=args.dataset_mode,
        split=args.split,
        data_path=args.data_path,
        output_path=args.output_path,
        range_idxs=tuple(args.range_idxs) if args.range_idxs else None,
        use_pc_completion=not args.no_pc_completion,
    )
    print(f"wrote {n} pairs")
    return n


if __name__ == "__main__":
    main()
