"""Drivers: how a configuration's entry point is driven through a run.

A configuration file names its driver (``"driver"``); the driver module
has a ``Cell`` class built from the configuration, the traffic mix, the
seed and the device, with ``warm()``, ``window(seconds)``, ``release()``,
``reference(device, rnd=None)`` and ``judge(record, expected)``
(``portbench/run.py`` calls them in that order), and ``stand_in(outputs)``,
which puts in the entry's place one that hands out each source's output
from ``outputs`` (``portbench/control.py``).
"""
