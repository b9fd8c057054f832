"""What the demos share: the device and plot flags, and the threshold exit."""

from __future__ import annotations

import argparse
import sys


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--plot", action="store_true",
                    help="save the demo's figure (needs matplotlib)")
    return ap


def sync(device) -> None:
    """Wait for the card, so that a host clock reads finished work."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def verdict(ok: bool, what: str) -> int:
    """0 when the result meets its threshold, else 1 with a message."""
    if not ok:
        print(f"FAILED: {what}", file=sys.stderr)
    return 0 if ok else 1
