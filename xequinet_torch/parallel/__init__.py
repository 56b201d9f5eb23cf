"""Multi-process training: the process group and data parallelism."""
