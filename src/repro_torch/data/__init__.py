"""Synthetic multitask classification data."""
from repro_torch.data.synthetic import MultitaskDataset, train_test_split
