"""Batch link-scoring CLI from a saved BUDDY or ELPH checkpoint.

    python -m subgraph_sketching_tpu_torch.runners.serve \
        --checkpoint_dir D --links queries.npy --out scores.npy

``D`` holds ``config.json`` and the newest ``step_<N>.pt`` of a training
run (``runners/run.py --checkpoint_dir D --save_model``; BUDDY or ELPH),
or ``config.json`` + ``buddy.pt`` (serving.save_buddy_checkpoint).
``--links`` accepts a .npy ([N, 2] int) or a whitespace text file with two
integer columns.  Scores are logits; pass them through a sigmoid for
probabilities.  Runs on CUDA unless ``--device cpu`` (or the JAX
package's ``--platform cpu``) is given; a ``--platform`` that conflicts
with ``--device`` raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def load_links(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        links = np.load(path)
    else:
        links = np.loadtxt(path, dtype=np.int64, ndmin=2)
    links = np.asarray(links)
    if links.ndim != 2 or links.shape[1] != 2:
        raise ValueError(f"--links must be [N, 2] (src, dst); got shape "
                         f"{links.shape}")
    if len(links) == 0:
        raise ValueError("--links file contains no link pairs")
    if not np.issubdtype(links.dtype, np.integer):
        if not np.array_equal(links, links.astype(np.int64)):
            raise ValueError("--links must contain integer node ids")
    return links.astype(np.int32)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint_dir", required=True,
                   help="checkpoint dir (config.json + step_<N>.pt or "
                        "buddy.pt)")
    p.add_argument("--links", required=True,
                   help=".npy or two-column text file of (src, dst) pairs")
    p.add_argument("--out", default=None,
                   help="write scores as .npy (default: print summary only)")
    p.add_argument("--split", default="train",
                   help="which split's message graph to serve against")
    p.add_argument("--min_bucket", type=int, default=1024)
    p.add_argument("--max_bucket", type=int, default=1 << 18)
    p.add_argument("--platform", default=None,
                   help="the JAX package's flag: cpu or gpu picks the "
                        "device when --device is not given; a value that "
                        "conflicts with --device raises")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: --platform's "
                        "device, else cuda)")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    from subgraph_sketching_tpu_torch.device import (
        device_from_flags, resolve_device,
    )
    from subgraph_sketching_tpu_torch.serving import scorer_from_checkpoint

    device = resolve_device(device_from_flags(args.device, args.platform))
    links = load_links(args.links)
    t0 = time.time()
    scorer = scorer_from_checkpoint(
        args.checkpoint_dir, split=args.split, min_bucket=args.min_bucket,
        max_bucket=args.max_bucket, device=device)
    print(f"rebuilt serving state on {scorer.device} in "
          f"{time.time() - t0:.2f}s")
    if links.min() < 0 or links.max() >= scorer.num_nodes:
        raise SystemExit(
            f"link ids must be in [0, {scorer.num_nodes}); got range "
            f"[{links.min()}, {links.max()}]")
    t0 = time.time()
    scores = scorer.score(links)
    dt = time.time() - t0
    print(f"scored {len(links)} links in {dt:.3f}s "
          f"({len(links) / max(dt, 1e-9):.0f} links/s)")
    print(f"score stats: min {scores.min():.4f} max {scores.max():.4f} "
          f"mean {scores.mean():.4f}")
    if args.out:
        np.save(args.out, scores)
        print(f"wrote {args.out}")
    return scores


if __name__ == "__main__":
    main()
