"""Shared command line of the demos: --cpu picks the device."""

from __future__ import annotations

import argparse


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return p


def device(args) -> str:
    return "cpu" if args.cpu else "cuda"
