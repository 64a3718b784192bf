"""Paper-scale CNN programs (the model zoo comes with a later slice)."""
