"""Runnable training loops (`python -m chatterbox_tpu_torch.examples.train_t3`,
`... .train_flow`)."""
