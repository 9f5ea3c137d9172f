"""The work a loop kind's paths need, counted from the cell's inputs (never
from the program's launches), one module per loop kind."""
