"""Plain references of the benchmark's configurations, one module per
configuration (`<config>.py`), in plain PyTorch; none imports the
program."""
