"""The JAX package's experimental kernels, ported: the megakernel forward
(``mega.py``, K12) and the two-level cluster sweep (``grid.py``, K13).

Neither is on a default path, as in the JAX package: ``render()`` does not
reach them. ``chip_smoke.py`` measures each against the route it would
replace on the card (phases ``mega_render`` and ``grid_sweep``).
"""
