"""One reader per metric, found by the metric's name: ``read(run)`` returns
the metric's value, or None where the run holds nothing to read."""
