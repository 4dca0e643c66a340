"""Build the pre-cut {split}.h5 that ``SEH5Dataset`` (``--h5``) reads, from paired clean
and noisy wav directories: the counterpart of the repo's ``tools/make_h5.py``, which
imports the JAX package. The same corpus and options give the same file: every slice of
``SEDataset`` in index order, normalized and pre-emphasized, clean under 'data' and noisy
under 'label', each (n, slice_size, 1) float32.

    python -m segan_pytorch_tpu_torch.tools.make_h5 --clean_dir C --noisy_dir N \\
        --out_dir h5 --split train [--slice_size 16384] [--stride 0.5] [--preemph 0.95]

The slice index is cached under ``--cache_dir`` (by default ``{out_dir}/cache``). Needs
``h5py``.
"""
from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--clean_dir", required=True)
    p.add_argument("--noisy_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--slice_size", type=int, default=16384)
    p.add_argument("--stride", type=float, default=0.5)
    p.add_argument("--preemph", type=float, default=0.95)
    p.add_argument("--cache_dir", default=None,
                   help="Slice index cache (Def: {out_dir}/cache).")
    return p


def main(argv=None) -> str:
    """Write {out_dir}/{split}.h5; returns its path."""
    args = build_parser().parse_args(argv)
    try:
        import h5py
    except ImportError as e:
        raise ImportError("make_h5 needs the h5py package, which is not installed") from e
    import numpy as np

    from ..data.loader import DataLoader
    from ..data.se_dataset import SEDataset

    ds = SEDataset(args.clean_dir, args.noisy_dir, args.preemph,
                   cache_dir=args.cache_dir or os.path.join(args.out_dir, "cache"),
                   split=args.split, slice_size=args.slice_size, stride=args.stride,
                   verbose=True, slice_workers=1)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, f"{args.split}.h5")
    n = len(ds)
    with h5py.File(out, "w") as f:
        dset_c = f.create_dataset("data", (n, args.slice_size, 1), np.float32)
        dset_n = f.create_dataset("label", (n, args.slice_size, 1), np.float32)
        i = 0
        for batch in DataLoader(ds, batch_size=256, shuffle=False, num_workers=2):
            b = int(batch["mask"].sum())  # the final batch's padding rows are left out
            dset_c[i: i + b] = batch["clean"][:b, :, None]
            dset_n[i: i + b] = batch["noisy"][:b, :, None]
            i += b
            print(f"\r{i}/{n} chunks", end="")
    print(f"\nWrote {out} with {n} chunk pairs")
    return out


if __name__ == "__main__":
    main()
