"""The device's idle share in the prefill cells, in %: read as ``idle.gen``
reads it."""

from pathlib import Path

from common import load_module

read = load_module(Path(__file__).with_name("idle.gen.py")).read
