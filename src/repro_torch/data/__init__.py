"""Synthetic data: LM token streams and multitask classification."""
from repro_torch.data.synthetic import MultitaskDataset, lm_batches, train_test_split
