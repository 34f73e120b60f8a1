"""What the ported scripts share: the device and output-directory flags and
the repository's root (for the committed inputs under benchmarks/)."""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = "results"


def parser(doc: str) -> argparse.ArgumentParser:
    """An ArgumentParser with `--device` and `--out-dir`."""
    ap = argparse.ArgumentParser(description=doc.strip().split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain twins)')
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="where reports are written (default: results/)")
    return ap


def device(args) -> torch.device:
    """The run's device; a missing card is an error, not a fallback."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "kernels' plain twins on the host")
    return dev


def out_path(args, name: str) -> str:
    """`name` under the run's output directory (made if needed)."""
    os.makedirs(args.out_dir, exist_ok=True)
    return os.path.join(args.out_dir, name)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
