"""The whole step's share of the card's bf16 peak in the prefill cells, in %:
read as ``mfu.gen`` reads it."""

from pathlib import Path

from common import load_module

read = load_module(Path(__file__).with_name("mfu.gen.py")).read
