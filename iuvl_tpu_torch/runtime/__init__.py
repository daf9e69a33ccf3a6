"""Run-time helpers of the trainer: checkpoints (``torch.save``),
loss meters and the JSONL metrics log with a ``torch.profiler`` trace."""
