"""The harness: the cell's files, the window, the trace, the statistics."""
