"""The paper's worked examples (Tables I/II, Examples 1-3)."""
