"""The port's command-line tools: `python -m pointtinybenchmark_tpu_torch.
tools.train` and `python -m pointtinybenchmark_tpu_torch.tools.test`."""
